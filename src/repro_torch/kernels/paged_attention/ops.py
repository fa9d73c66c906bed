"""Paged decode attention partials (kernel K1, ``csrc/paged_decode.cu``).

``paged_decode_partials`` computes, for one KV pool, the flash-decode
partials ``(m, l, acc)`` of one query token per request over the slots that
request owns, on the engine's inverted layout (``slot_req``/``slot_base``).
On a CUDA tensor it launches the kernel; on the CPU it runs
``paged_decode_partials_plain``, the same function in PyTorch.  The kernel
takes any GQA group from 1 to 16 query heads per kv head and head dims that
are a multiple of 4 up to 128; it splits each request's slots over
``num_splits`` blocks and merges the splits by LSE.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, refuse_grad

NEG_INF = -1e30
MAX_GQ = 16
MAX_HEAD_DIM = 128
#: the kernel's grid aims at about one wave of this many blocks per SM
BLOCKS_PER_SM = 4
#: a split takes at least this many of a request's slots on average
MIN_SLOTS_PER_SPLIT = 2


class Partials(NamedTuple):
    m: torch.Tensor    # (b, nkv, gq)        running max
    l: torch.Tensor    # (b, nkv, gq)        running denominator
    acc: torch.Tensor  # (b, nkv, gq, hd)    running numerator


def _valid_positions(slot_req, slot_base, q_pos, bs: int,
                     sliding_window: Optional[int],
                     attention_chunk: Optional[int]):
    """(n_slots, bs) mask of the positions a slot contributes to its
    owner's query, and the owner's row clipped into range."""
    b = q_pos.shape[0]
    req = torch.clamp(slot_req, 0, b - 1).long()
    pos = slot_base[:, None] + torch.arange(bs, dtype=slot_base.dtype,
                                            device=slot_base.device)[None, :]
    qp = q_pos[req][:, None]
    valid = (slot_req[:, None] >= 0) & (pos <= qp) & (pos >= 0)
    if sliding_window is not None:
        valid &= pos > (qp - sliding_window)
    if attention_chunk is not None:
        valid &= torch.div(pos, attention_chunk, rounding_mode="floor") == \
            torch.div(qp, attention_chunk, rounding_mode="floor")
    return valid, req


def paged_decode_partials_plain(q, pool_k, pool_v, slot_req, slot_base,
                                q_pos, *, scale: float,
                                sliding_window: Optional[int] = None,
                                attention_chunk: Optional[int] = None,
                                logit_softcap: Optional[float] = None
                                ) -> Partials:
    """PyTorch version of the kernel: per-slot partials, then a segment
    log-sum-exp merge into per-request partials (the JAX code's order)."""
    b, nq, hd = q.shape
    n_slots, bs, nkv, _ = pool_k.shape
    gq = nq // nkv
    f32 = torch.float32
    valid, req = _valid_positions(slot_req, slot_base, q_pos, bs,
                                  sliding_window, attention_chunk)
    qn = (q[req].to(f32) * scale).reshape(n_slots, nkv, gq, hd)
    s = torch.einsum("nKgh,nsKh->nKgs", qn.to(pool_k.dtype).to(f32),
                     pool_k.to(f32))                          # (n,nkv,gq,bs)
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=f32, device=s.device))
    m_n = s.amax(dim=-1)                                      # (n,nkv,gq)
    p = torch.exp(s - m_n[..., None])
    p = torch.where(valid[:, None, None, :], p, torch.zeros((), dtype=f32,
                                                             device=s.device))
    l_n = p.sum(dim=-1)
    acc_n = torch.einsum("nKgs,nsKh->nKgh", p.to(pool_v.dtype).to(f32),
                         pool_v.to(f32))

    # segment LSE merge; row b is the trash row of free slots
    owned = slot_req >= 0
    seg = torch.where(owned, slot_req, torch.full_like(slot_req, b)).long()
    m_r = torch.full((b + 1, nkv, gq), float("-inf"), dtype=f32,
                     device=s.device)
    m_r = m_r.scatter_reduce(0, seg[:, None, None].expand_as(m_n), m_n,
                             reduce="amax")[:b]
    m_r = torch.clamp(m_r, min=NEG_INF)
    corr = torch.exp(m_n - m_r[torch.clamp(seg, 0, b - 1)])
    corr = torch.where(owned[:, None, None], corr, torch.zeros((), dtype=f32,
                                                               device=s.device))
    l_r = torch.zeros((b + 1, nkv, gq), dtype=f32, device=s.device)
    l_r = l_r.index_add(0, seg, l_n * corr)[:b]
    acc_r = torch.zeros((b + 1, nkv, gq, hd), dtype=f32, device=s.device)
    acc_r = acc_r.index_add(0, seg, acc_n * corr[..., None])[:b]
    return Partials(m=m_r, l=l_r, acc=acc_r)


def num_splits(b: int, nkv: int, n_slots: int, sms: int) -> int:
    """Blocks each (request, kv head) is split over, from the pool's shape
    and the card's ``sms`` alone: about one wave of ``BLOCKS_PER_SM``
    blocks per SM, where the pool holds ``MIN_SLOTS_PER_SPLIT`` slots per
    split and request.  It does not grow with the pool past that: a block
    takes any number of slots, in rounds."""
    want = -(-BLOCKS_PER_SM * sms // (b * nkv))
    return min(want, max(1, n_slots // (b * MIN_SLOTS_PER_SPLIT)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.library("paged_decode")
    fn = lib.paged_decode_partials
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.paged_decode_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.paged_decode_workspace_bytes.restype = ctypes.c_size_t
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, pool_k, pool_v, slot_req, slot_base, q_pos):
    if q.dim() != 3 or pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"paged_decode_partials: q {tuple(q.shape)} must be "
                         f"(b, nq, hd) and the pools (n_slots, bs, nkv, hd) "
                         f"alike, got {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)}")
    b, nq, hd = q.shape
    n_slots, bs, nkv, hd_p = pool_k.shape
    if hd_p != hd or nq % nkv:
        raise ValueError(f"paged_decode_partials: q heads {nq}x{hd} do not "
                         f"fold onto pool heads {nkv}x{hd_p}")
    if slot_req.shape != (n_slots,) or slot_base.shape != (n_slots,) \
            or q_pos.shape != (b,):
        raise ValueError("paged_decode_partials: slot_req/slot_base must be "
                         f"({n_slots},) and q_pos ({b},)")


def paged_decode_partials(q, pool_k, pool_v, slot_req, slot_base, q_pos, *,
                          scale: float,
                          sliding_window: Optional[int] = None,
                          attention_chunk: Optional[int] = None,
                          logit_softcap: Optional[float] = None) -> Partials:
    """Flash-decode partials of one pool.  q: (b, nq, hd); pools:
    (n_slots, bs, nkv, hd); slot_req/slot_base: (n_slots,) int32 (-1 = free
    slot); q_pos: (b,) int32.  Returns f32 ``Partials``."""
    _check(q, pool_k, pool_v, slot_req, slot_base, q_pos)
    if q.device.type == "cpu":
        return paged_decode_partials_plain(
            q, pool_k, pool_v, slot_req, slot_base, q_pos, scale=scale,
            sliding_window=sliding_window, attention_chunk=attention_chunk,
            logit_softcap=logit_softcap)
    refuse_grad("paged_decode_partials", q, pool_k, pool_v)
    b, nq, hd = q.shape
    n_slots, bs, nkv, _ = pool_k.shape
    tensors = (q, pool_k, pool_v, slot_req, slot_base, q_pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_partials: every operand must be on "
                         f"{q.device}")
    if q.dtype != torch.float32 or pool_k.dtype != torch.float32 \
            or pool_v.dtype != torch.float32:
        raise TypeError("paged_decode_partials: the kernel takes f32 q and "
                        f"pools, got {q.dtype} / {pool_k.dtype}")
    if any(t.dtype != torch.int32 for t in (slot_req, slot_base, q_pos)):
        raise TypeError("paged_decode_partials: slot_req, slot_base and "
                        "q_pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_partials: operands must be contiguous")
    gq = nq // nkv
    if gq > MAX_GQ:
        raise ValueError(f"paged_decode_partials: {gq} query heads per kv "
                         f"head; the kernel takes 1 to {MAX_GQ}")
    if hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_partials: head dim {hd}; the kernel "
                         f"takes a multiple of 4 up to {MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged_decode_partials: q and the pools must be "
                         "16-byte aligned (the kernel reads float4 rows)")
    m = torch.empty((b, nkv, gq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, nkv, gq, hd), dtype=torch.float32, device=q.device)
    if b == 0:
        return Partials(m, l, acc)
    splits = num_splits(b, nkv, n_slots, sm_count(q.device))
    lib = _kernel()
    # the splits' partials when there are several, and the slot counts of
    # a table of more than one chunk
    nbytes = lib.paged_decode_workspace_bytes(b, nkv, gq, hd, n_slots,
                                              splits)
    work = torch.empty((nbytes,), dtype=torch.uint8,
                       device=q.device) if nbytes else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_partials(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            slot_req.data_ptr(), slot_base.data_ptr(), q_pos.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            None if work is None else work.data_ptr(), b,
            nq, nkv, hd, n_slots, bs, splits, sliding_window or 0,
            attention_chunk or 0, scale, logit_softcap or 0.0, stream)
    if rc != 0:
        raise RuntimeError("paged_decode_partials: launch failed: "
                           + lib.paged_decode_error_string(rc).decode())
    paged_decode_partials.launches += 1
    return Partials(m, l, acc)


#: kernel launches since the count was last set to 0
paged_decode_partials.launches = 0
