"""Prefill attention (kernel K4, ``csrc/flash_prefill.cu``) and its
backward.

``prefill_attention`` computes causal GQA attention of a full sequence in
the model layout, masked from token positions (causal, optional sliding
window, optional chunked-local) with an optional logit softcap.  On a CUDA
tensor it launches the kernel: bf16 on the tensor cores (head dim a
multiple of 8), f32 on the CUDA cores; on the CPU it runs
``prefill_attention_plain``, the same function in PyTorch: an online
softmax over key chunks, which ``repro_torch.models.layers.
chunked_attention`` is under the JAX package's name.

When grad mode is on and q, k or v requires grad, ``prefill_attention``
goes through ``PrefillAttention``, a ``torch.autograd.Function``: its
forward also writes each row's log-sum-exp, and its backward is
``prefill_attention_bwd``, the backward kernel on a CUDA tensor and
``prefill_attention_bwd_plain`` on the CPU.  The JAX package has no
backward kernel (XLA differentiates ``chunked_attention``); this one
computes that gradient.
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
                            kv_chunk: int = 1024, return_lse: bool = False):
    """Causal GQA attention with an online softmax over KV chunks.

    q: (b, sq, nq, hd);  k, v: (b, sk, nkv, hd)
    q_positions: (b, sq);  k_positions: (b, sk)
    Returns (b, sq, nq, hd) in q's dtype, and with ``return_lse`` also
    each row's log-sum-exp of its masked scores, ``m + log(max(l,
    1e-30))``, f32 (b, nq, sq): what the backward reads.

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

    k, v, k_positions, kv_chunk, n_chunks = _pad_keys(k, v, k_positions,
                                                      kv_chunk)
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
    den = torch.clamp(l, min=1e-30)
    out = (acc / den[..., None]).reshape(b, sq, nq, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(den)).reshape(b, sq, nq).transpose(1, 2)
    return out, lse.contiguous()


def _pad_keys(k, v, k_positions, kv_chunk):
    """k, v and their positions padded to whole chunks of ``kv_chunk``
    keys, the pad keys at ``PAD_POSITION``, which every mask rejects.
    Returns (k, v, k_positions, kv_chunk, n_chunks)."""
    sk = k.shape[1]
    kv_chunk = min(kv_chunk, sk)
    n_chunks = -(-sk // kv_chunk)
    pad = n_chunks * kv_chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=PAD_POSITION)
    return k, v, k_positions, kv_chunk, n_chunks


def prefill_attention_bwd_plain(q, k, v, o, lse, do, q_positions,
                                k_positions, *,
                                sliding_window: Optional[int] = None,
                                attention_chunk: Optional[int] = None,
                                logit_softcap: Optional[float] = None,
                                kv_chunk: int = 1024):
    """The gradient of ``prefill_attention_plain`` from its output ``o``
    and row log-sum-exp ``lse`` (b, nq, sq): flash attention's backward
    over key chunks.  Returns (dq, dk, dv) in the operands' dtype.

    Products sum in f32 from the operands' values: S = (q * scale,
    rounded to q's dtype) k^T, P = exp(S - lse) (0 where masked), dP = do
    v^T, D = rowsum(do * o), dS = P (dP - D), times 1 - (s / c)^2 under a
    logit softcap c (s the capped score); dv = P^T do, dk = dS^T (q *
    scale), dq = dS k * scale, each rounded once to the operands' dtype.
    P and dS enter their products rounded to the operands' dtype (a no-op
    in f32), as the kernel's tensor cores take them and as the forward
    rounds p.
    """
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    gq = nq // nkv
    scale = hd ** -0.5
    k, v, k_positions, kv_chunk, n_chunks = _pad_keys(k, v, k_positions,
                                                      kv_chunk)
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float().reshape(
        b, sq, nkv, gq, hd)
    dof = do.float().reshape(b, sq, nkv, gq, hd)
    lse_f = lse.transpose(1, 2).reshape(b, sq, nkv, gq)
    delta = (dof * o.float().reshape(b, sq, nkv, gq, hd)).sum(-1)
    dqs = torch.zeros_like(qs)
    dks, dvs = [], []
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kj, vj, posj = k[:, sl].float(), v[:, sl].float(), k_positions[:, sl]
        mask = band_mask(q_positions, posj, sliding_window,
                         attention_chunk)[:, :, None, None, :]
        s = torch.einsum("bqKgh,bcKh->bqKgc", qs, kj)
        if logit_softcap:
            th = torch.tanh(s / logit_softcap)
            s = logit_softcap * th
        p = torch.where(mask, torch.exp(s - lse_f[..., None]), zero)
        dp = torch.einsum("bqKgh,bcKh->bqKgc", dof, vj)
        ds = p * (dp - delta[..., None])
        if logit_softcap:
            ds = ds * (1 - th * th)
        p = p.to(v.dtype).float()
        ds = ds.to(q.dtype).float()
        dvs.append(torch.einsum("bqKgc,bqKgh->bcKh", p, dof))
        dks.append(torch.einsum("bqKgc,bqKgh->bcKh", ds, qs))
        dqs += torch.einsum("bqKgc,bcKh->bqKgh", ds, kj)
    dq = (dqs * scale).reshape(b, sq, nq, hd).to(q.dtype)
    dk = torch.cat(dks, dim=1)[:, :sk].to(k.dtype)
    dv = torch.cat(dvs, dim=1)[:, :sk].to(v.dtype)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.library("flash_prefill")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_prefill.argtypes = [p] * 7 + [i] * 9 + [f, f, p]
    lib.flash_prefill.restype = i
    lib.flash_prefill_bwd.argtypes = [p] * 13 + [i] * 9 + [f, f, p]
    lib.flash_prefill_bwd.restype = i
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


def _check_kernel_operands(what, q, k, v, q_positions, k_positions,
                           *more) -> None:
    """What the CUDA kernels take: one device, q, k and v (and ``more``)
    of one dtype, bf16 or f32, int32 positions, contiguous operands, gq
    and hd within the kernels' limits."""
    tensors = (q, k, v, q_positions, k_positions, *more)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: every operand must be on {q.device}")
    if q.dtype not in _DTYPE_CODE \
            or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise TypeError(f"{what}: the kernel takes q, k and v of one dtype, "
                        f"bf16 or f32; got {q.dtype} / {k.dtype} / "
                        f"{v.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError(f"{what}: positions must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    nq, hd = q.shape[2], q.shape[3]
    if nq // k.shape[2] > MAX_GQ or hd > MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes at most {MAX_GQ} query "
                         f"heads per kv head and head dim {MAX_HEAD_DIM}; "
                         f"got {nq // k.shape[2]} and {hd}")


def _scale(q) -> float:
    """hd ** -0.5 rounded to q's dtype, as the plain version scales q."""
    return torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype).item()


def _launch_forward(q, k, v, q_positions, k_positions, *,
                    sliding_window=None, attention_chunk=None,
                    logit_softcap=None, want_lse: bool = False):
    """Launch K4's forward on CUDA operands; returns (out, lse or None)."""
    _check_kernel_operands("prefill_attention", q, k, v, q_positions,
                           k_positions)
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel moves rows in 16-byte copies
        if hd % 8:
            raise ValueError(f"prefill_attention: the bf16 kernel takes a "
                             f"head dim that is a multiple of 8; got {hd}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("prefill_attention: the bf16 kernel takes q, k "
                             "and v at 16-byte aligned addresses")
    out = torch.empty_like(q)
    lse = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    lib = _kernel()
    with torch.cuda.device(q.device):
        rc = lib.flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            k_positions.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, sk, nq, nkv, hd,
            _DTYPE_CODE[q.dtype], sliding_window or 0, attention_chunk or 0,
            _scale(q), logit_softcap or 0.0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("prefill_attention: launch failed: "
                           + lib.flash_prefill_error_string(rc).decode())
    prefill_attention.launches += 1
    return out, lse


class PrefillAttention(torch.autograd.Function):
    """``prefill_attention`` with a gradient.  The forward writes the
    output and each row's log-sum-exp (the kernel on a CUDA tensor, the
    plain version on the CPU) and saves q, k, v, the output and the LSE;
    the backward is ``prefill_attention_bwd``.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass
    (a second launch), and the backward reads what that run saved."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, sliding_window,
                attention_chunk, logit_softcap):
        masks = dict(sliding_window=sliding_window,
                     attention_chunk=attention_chunk,
                     logit_softcap=logit_softcap)
        if q.device.type == "cpu":
            out, lse = prefill_attention_plain(
                q, k, v, q_positions, k_positions, return_lse=True, **masks)
        else:
            out, lse = _launch_forward(q, k, v, q_positions, k_positions,
                                       want_lse=True, **masks)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, k_positions)
        ctx.masks = masks
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_positions, k_positions = ctx.saved_tensors
        dq, dk, dv = prefill_attention_bwd(
            q, k, v, out, lse, do.contiguous(), q_positions, k_positions,
            **ctx.masks)
        return dq, dk, dv, None, None, None, None, None


def prefill_attention(q, k, v, q_positions, k_positions, *,
                      sliding_window: Optional[int] = None,
                      attention_chunk: Optional[int] = None,
                      logit_softcap: Optional[float] = None):
    """q: (b, sq, nq, hd); k, v: (b, sk, nkv, hd); q_positions (b, sq) and
    k_positions (b, sk) int32.  Returns (b, sq, nq, hd) in q's dtype.
    With grad mode on and q, k or v requiring grad it goes through
    ``PrefillAttention``, whose backward is a kernel too."""
    _check(q, k, v, q_positions, k_positions)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return PrefillAttention.apply(q, k, v, q_positions, k_positions,
                                      sliding_window, attention_chunk,
                                      logit_softcap)
    if q.device.type == "cpu":
        return prefill_attention_plain(
            q, k, v, q_positions, k_positions, sliding_window=sliding_window,
            attention_chunk=attention_chunk, logit_softcap=logit_softcap)
    return _launch_forward(q, k, v, q_positions, k_positions,
                           sliding_window=sliding_window,
                           attention_chunk=attention_chunk,
                           logit_softcap=logit_softcap)[0]


#: kernel launches since the count was last set to 0
prefill_attention.launches = 0


def prefill_attention_bwd(q, k, v, o, lse, do, q_positions, k_positions, *,
                          sliding_window: Optional[int] = None,
                          attention_chunk: Optional[int] = None,
                          logit_softcap: Optional[float] = None):
    """The gradient (dq, dk, dv) of ``prefill_attention`` at output ``o``
    with row log-sum-exp ``lse`` (b, nq, sq) f32, for the output's
    cotangent ``do``.  On a CUDA tensor one call launches the backward's
    three kernels (D and the scaled q, dK/dV, dQ: bf16 on the tensor
    cores, f32 on the CUDA cores) and counts one launch; on the CPU it
    runs ``prefill_attention_bwd_plain``."""
    _check(q, k, v, q_positions, k_positions)
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (b, nq, sq):
        raise ValueError(f"prefill_attention_bwd: o and do must be "
                         f"{tuple(q.shape)} and lse ({b}, {nq}, {sq}); got "
                         f"{tuple(o.shape)}, {tuple(do.shape)} and "
                         f"{tuple(lse.shape)}")
    masks = dict(sliding_window=sliding_window,
                 attention_chunk=attention_chunk, logit_softcap=logit_softcap)
    if q.device.type == "cpu":
        return prefill_attention_bwd_plain(q, k, v, o, lse, do, q_positions,
                                           k_positions, **masks)
    _check_kernel_operands("prefill_attention_bwd", q, k, v, q_positions,
                           k_positions, o, do)
    if lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise TypeError("prefill_attention_bwd: lse must be contiguous f32 "
                        f"on {q.device}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (hd % 8 or any(t.data_ptr() % 16 for t in (q, k, v, do))):
        raise ValueError("prefill_attention_bwd: the bf16 kernels take a head "
                         "dim that is a multiple of 8 and q, k, v and do at "
                         "16-byte aligned addresses")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
    # bf16: q * scale, rounded as the forward rounds it, for the tiles
    qs = torch.empty_like(q) if bf16 else None
    lib = _kernel()
    with torch.cuda.device(q.device):
        rc = lib.flash_prefill_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), q_positions.data_ptr(),
            k_positions.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            None if qs is None else qs.data_ptr(), b, sq, sk, nq, nkv, hd,
            _DTYPE_CODE[q.dtype], sliding_window or 0, attention_chunk or 0,
            _scale(q), logit_softcap or 0.0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("prefill_attention_bwd: launch failed: "
                           + lib.flash_prefill_error_string(rc).decode())
    prefill_attention_bwd.launches += 1
    return dq, dk, dv


#: backward calls (three kernels each) since the count was last set to 0
prefill_attention_bwd.launches = 0
