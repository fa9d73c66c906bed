"""Prefill attention (kernel K4, ``csrc/flash_prefill.cu``).

``prefill_attention`` computes causal GQA attention of a full sequence in
the model layout, masked from token positions (causal, optional sliding
window, optional chunked-local) with an optional logit softcap.  On a CUDA
tensor it launches the kernel: bf16 on the tensor cores (head dim a
multiple of 8), f32 on the CUDA cores; on the CPU it runs
``prefill_attention_plain``, the same function in PyTorch: an online
softmax over key chunks, which ``repro_torch.models.layers.
chunked_attention`` is under the JAX package's name.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
#: position given to the keys that pad the last chunk: after every query,
#: so the causal test rejects them, and in no query's attention chunk
PAD_POSITION = 2 ** 30
MAX_GQ = 64
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def band_mask(q_pos, k_pos, sliding_window: Optional[int] = None,
              attention_chunk: Optional[int] = None):
    """(..., q, k) boolean mask combining causal + sliding-window +
    chunked-local; leading dims of ``q_pos``/``k_pos`` batch over."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    m = kp <= qp                                           # causal
    if sliding_window is not None:
        m &= kp > (qp - sliding_window)
    if attention_chunk is not None:                        # chunked local
        c = attention_chunk
        m &= torch.div(kp, c, rounding_mode="floor") == \
            torch.div(qp, c, rounding_mode="floor")
    return m


def prefill_attention_plain(q, k, v, q_positions, k_positions, *,
                            sliding_window: Optional[int] = None,
                            attention_chunk: Optional[int] = None,
                            logit_softcap: Optional[float] = None,
                            kv_chunk: int = 1024):
    """Causal GQA attention with an online softmax over KV chunks.

    q: (b, sq, nq, hd);  k, v: (b, sk, nkv, hd)
    q_positions: (b, sq);  k_positions: (b, sk)
    Returns (b, sq, nq, hd) in q's dtype.

    The grouped layout of the JAX path without a mesh: q is folded to
    (b, sq, nkv, gq, hd); products take the working-dtype operands and sum
    in f32, and the probabilities are rounded to v's dtype before the
    second product, as ``preferred_element_type=f32`` does there.  Keys
    that pad the last chunk sit at ``PAD_POSITION``, which every mask
    rejects, and a rejected key adds nothing (p = 0), as in the Pallas
    kernel and its oracle.
    """
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    gq = nq // nkv
    scale = hd ** -0.5

    kv_chunk = min(kv_chunk, sk)
    n_chunks = -(-sk // kv_chunk)
    pad = n_chunks * kv_chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=PAD_POSITION)

    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, sq, nkv, gq, hd)
    qf = qf.float()
    m = torch.full((b, sq, nkv, gq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, nkv, gq, hd), dtype=torch.float32,
                      device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kj, vj, posj = k[:, sl], v[:, sl], k_positions[:, sl]
        mask = band_mask(q_positions, posj, sliding_window,
                         attention_chunk)[:, :, None, None, :]
        s = torch.einsum("bqKgh,bcKh->bqKgc", qf, kj.float())
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                              device=s.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), zero)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        upd = torch.einsum("bqKgc,bcKh->bqKgh", p.to(vj.dtype).float(),
                           vj.float())
        acc = acc * corr[..., None] + upd
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, nq, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.library("flash_prefill")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_prefill.argtypes = [p] * 6 + [i] * 9 + \
        [ctypes.c_float, ctypes.c_float, p]
    lib.flash_prefill.restype = i
    lib.flash_prefill_error_string.argtypes = [i]
    lib.flash_prefill_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, q_positions, k_positions) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} must be "
                         f"(b, sq, nq, hd) and k, v (b, sk, nkv, hd) alike, "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")
    b, sq, nq, hd = q.shape
    _, sk, nkv, hd_k = k.shape
    if k.shape[0] != b or hd_k != hd or nkv == 0 or nq % nkv:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} does not "
                         f"fold onto k {tuple(k.shape)}")
    if tuple(q_positions.shape) != (b, sq) \
            or tuple(k_positions.shape) != (b, sk):
        raise ValueError(f"prefill_attention: positions must be ({b}, {sq}) "
                         f"and ({b}, {sk}), got {tuple(q_positions.shape)} "
                         f"and {tuple(k_positions.shape)}")


def prefill_attention(q, k, v, q_positions, k_positions, *,
                      sliding_window: Optional[int] = None,
                      attention_chunk: Optional[int] = None,
                      logit_softcap: Optional[float] = None):
    """q: (b, sq, nq, hd); k, v: (b, sk, nkv, hd); q_positions (b, sq) and
    k_positions (b, sk) int32.  Returns (b, sq, nq, hd) in q's dtype."""
    _check(q, k, v, q_positions, k_positions)
    if q.device.type == "cpu":
        return prefill_attention_plain(
            q, k, v, q_positions, k_positions, sliding_window=sliding_window,
            attention_chunk=attention_chunk, logit_softcap=logit_softcap)
    tensors = (q, k, v, q_positions, k_positions)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"prefill_attention: every operand must be on "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("prefill_attention: the kernel takes q, k and v of "
                        "one dtype, bf16 or f32; got "
                        f"{q.dtype} / {k.dtype} / {v.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("prefill_attention: positions must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("prefill_attention: operands must be contiguous")
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if nq // nkv > MAX_GQ or hd > MAX_HEAD_DIM:
        raise ValueError(f"prefill_attention: the kernel takes at most "
                         f"{MAX_GQ} query heads per kv head and head dim "
                         f"{MAX_HEAD_DIM}; got {nq // nkv} and {hd}")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel moves rows in 16-byte copies
        if hd % 8:
            raise ValueError(f"prefill_attention: the bf16 kernel takes a "
                             f"head dim that is a multiple of 8; got {hd}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("prefill_attention: the bf16 kernel takes q, k "
                             "and v at 16-byte aligned addresses")
    out = torch.empty_like(q)
    # the plain version scales q by hd ** -0.5 rounded to q's dtype
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    lib = _kernel()
    with torch.cuda.device(q.device):
        rc = lib.flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            k_positions.data_ptr(), out.data_ptr(), b, sq, sk, nq, nkv, hd,
            _DTYPE_CODE[q.dtype], sliding_window or 0, attention_chunk or 0,
            scale, logit_softcap or 0.0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("prefill_attention: launch failed: "
                           + lib.flash_prefill_error_string(rc).decode())
    prefill_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
prefill_attention.launches = 0
