"""Harvest block movers: quantize-on-demote and dequantize-on-reload
(kernels K2 and K3, ``csrc/harvest_quant.cu``), plus the plain scatter and
copy of pool rows.

``quantize_blocks`` and ``dequantize_blocks`` launch their kernel on a CUDA
tensor and run their plain PyTorch version (``*_plain``) on the CPU.  The
checks of the JAX wrappers are kept and raise the same exceptions:
``IndexError`` for slot ids out of range, ``ValueError`` for an unknown
fidelity or a bad shape, ``TypeError`` for a pool that is not floating.
``scatter_blocks`` and ``copy_blocks`` are plain PyTorch on any device.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

#: symmetric quantization range per wire fidelity (e4m3's largest finite
#: value is 448; int4 packs two's-complement nibbles, so +-7 keeps the
#: packing sign-safe)
FIDELITY_QMAX = {"int8": 127.0, "fp8": 448.0, "int4": 7.0}

#: storage dtype of the packed value plane per wire fidelity
FIDELITY_QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                   "int4": torch.uint8}

_FIDELITY_CODE = {"int8": 0, "fp8": 1, "int4": 2}


def _packed_width(elems: int, fidelity: str) -> int:
    """Columns of the packed value plane for a block of ``elems`` weights
    (int4 packs two nibbles per byte; an odd width pads)."""
    return (elems + 1) // 2 if fidelity == "int4" else elems


def _ids_host(slot_ids) -> np.ndarray:
    if isinstance(slot_ids, torch.Tensor):
        return slot_ids.detach().cpu().numpy()
    return np.asarray(slot_ids)


def _check_slot_ids(slot_ids, n_slots: int, what: str) -> None:
    """Reject out-of-range slot ids: a write that silently lands nowhere is
    data loss, not a masking convenience."""
    ids = _ids_host(slot_ids)
    if ids.size and (ids.min() < 0 or ids.max() >= n_slots):
        bad = ids[(ids < 0) | (ids >= n_slots)]
        raise IndexError(
            f"{what}: slot ids {bad.tolist()} out of range for a pool of "
            f"{n_slots} slots — refusing to drop the writes")


def _check_fidelity(fidelity: str, what: str) -> None:
    if fidelity not in FIDELITY_QMAX:
        raise ValueError(f"{what}: unknown fidelity {fidelity!r} — one of "
                         f"{sorted(FIDELITY_QMAX)}")


def _check_pool(pool, what: str) -> None:
    if getattr(pool, "ndim", None) != 2:
        raise ValueError(f"{what}: pool must be 2-D (n_slots, block_elems), "
                         f"got shape {tuple(getattr(pool, 'shape', ()))}")
    if not pool.dtype.is_floating_point:
        raise TypeError(f"{what}: pool dtype {pool.dtype} is not floating — "
                        "quantization needs a full-precision source")


def _ids_tensor(slot_ids, device) -> torch.Tensor:
    ids = slot_ids if isinstance(slot_ids, torch.Tensor) \
        else torch.as_tensor(np.asarray(slot_ids))
    return ids.to(device=device, dtype=torch.int32).contiguous()


def _check_kernel_operands(what: str, pool, *tensors) -> None:
    if pool.dtype != torch.float32:
        raise TypeError(f"{what}: the kernel takes an f32 pool, got "
                        f"{pool.dtype}")
    if any(t.device != pool.device for t in tensors):
        raise ValueError(f"{what}: every operand must be on {pool.device}")
    if not all(t.is_contiguous() for t in (pool,) + tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if pool.shape[1] == 0:
        raise ValueError(f"{what}: empty block rows")


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.library("harvest_quant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quantize_demote.argtypes = [p, p, i, i, i, i, p, p, p, p]
    lib.quantize_demote.restype = i
    lib.dequantize_reload.argtypes = [p, p, i, i, i, i, p, p, p]
    lib.dequantize_reload.restype = i
    lib.harvest_quant_error_string.argtypes = [i]
    lib.harvest_quant_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed: "
                           + lib.harvest_quant_error_string(rc).decode())


# ---------------------------------------------------------------------------
# K2: quantize-on-demote
# ---------------------------------------------------------------------------


def quantize_blocks_plain(src_pool, slot_ids, fidelity: str = "int8"):
    """Gather rows, per-row absmax scale (1 for an all-zero row), quantize
    and pack: the Pallas kernel's arithmetic in PyTorch."""
    ids = _ids_tensor(slot_ids, src_pool.device).long()
    rows = src_pool[ids].float()
    if fidelity == "int4" and rows.shape[1] % 2:
        rows = torch.nn.functional.pad(rows, (0, 1))
    absmax = rows.abs().amax(dim=1, keepdim=True) if rows.shape[0] \
        else torch.zeros((0, 1), device=rows.device)
    # absmax times the f32 reciprocal of qmax: XLA compiles the JAX
    # kernel's division by a constant so, and the scales must match its bits
    inv_qmax = torch.tensor(1.0, dtype=torch.float32) / FIDELITY_QMAX[fidelity]
    scales = torch.where(absmax == 0.0, torch.ones_like(absmax),
                         absmax * inv_qmax)
    x = rows / scales
    if fidelity == "int8":
        values = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    elif fidelity == "fp8":
        values = x.to(torch.float8_e4m3fn)
    else:
        q = torch.clamp(torch.round(x), -7, 7).to(torch.int32)
        q = q.reshape(q.shape[0], -1, 2)
        values = ((q[..., 0] & 15) | ((q[..., 1] & 15) << 4)).to(torch.uint8)
    return values, scales.float()


def quantize_blocks(src_pool, slot_ids, *, fidelity: str = "int8"):
    """Quantize-on-demote: pack ``src_pool[slot_ids]`` into the wire
    fidelity's ``(values (m, width), scales (m, 1) f32)`` pair."""
    _check_fidelity(fidelity, "quantize_blocks")
    _check_pool(src_pool, "quantize_blocks")
    _check_slot_ids(slot_ids, src_pool.shape[0], "quantize_blocks")
    if src_pool.device.type == "cpu":
        return quantize_blocks_plain(src_pool, slot_ids, fidelity)
    ids = _ids_tensor(slot_ids, src_pool.device)
    _check_kernel_operands("quantize_blocks", src_pool, ids)
    m, elems = ids.shape[0], src_pool.shape[1]
    width = _packed_width(elems, fidelity)
    dev = src_pool.device
    values = torch.empty((m, width), dtype=FIDELITY_QDTYPE[fidelity],
                         device=dev)
    scales = torch.empty((m, 1), dtype=torch.float32, device=dev)
    absmax = torch.zeros((m,), dtype=torch.float32, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.quantize_demote(
            src_pool.data_ptr(), ids.data_ptr(), m, elems, width,
            _FIDELITY_CODE[fidelity], absmax.data_ptr(), values.data_ptr(),
            scales.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "quantize_blocks")
    quantize_blocks.launches += 1
    return values, scales


# ---------------------------------------------------------------------------
# K3: dequantize-on-reload
# ---------------------------------------------------------------------------


def dequantize_blocks_plain(dst_pool, values, scales, slot_ids,
                            fidelity: str = "int8"):
    """Unpack, rescale and scatter into ``dst_pool`` in place (untouched
    slots keep their bits); returns ``dst_pool``."""
    if fidelity == "int4":
        b = values.to(torch.int32)
        lo = (b & 15) - 2 * (b & 8)
        hi = ((b >> 4) & 15) - 2 * ((b >> 4) & 8)
        x = torch.stack([lo, hi], dim=-1).reshape(values.shape[0], -1)
        x = x.float()
    else:
        x = values.float()
    rows = (x * scales)[:, :dst_pool.shape[1]]
    ids = _ids_tensor(slot_ids, dst_pool.device).long()
    dst_pool[ids] = rows.to(dst_pool.dtype)
    return dst_pool


def dequantize_blocks(dst_pool, values, scales, slot_ids, *,
                      fidelity: str = "int8"):
    """Dequantize-on-reload into ``dst_pool[slot_ids]``, in place (the
    JAX kernel aliases its output to the pool; here the pool is updated
    where it lies).  ``slot_ids`` must be unique.  Returns ``dst_pool``."""
    _check_fidelity(fidelity, "dequantize_blocks")
    _check_pool(dst_pool, "dequantize_blocks")
    _check_slot_ids(slot_ids, dst_pool.shape[0], "dequantize_blocks")
    host_ids = _ids_host(slot_ids).reshape(-1)
    m = host_ids.shape[0]
    elems = dst_pool.shape[1]
    width = _packed_width(elems + (elems % 2 if fidelity == "int4" else 0),
                          fidelity)
    if tuple(values.shape) != (m, width):
        raise ValueError(
            f"dequantize_blocks: values shape {tuple(values.shape)} does not "
            f"match {m} blocks of packed width {width} at {fidelity}")
    if tuple(scales.shape) != (m, 1):
        raise ValueError(f"dequantize_blocks: scales shape "
                         f"{tuple(scales.shape)} != ({m}, 1)")
    if np.unique(host_ids).size != m:
        raise ValueError("dequantize_blocks: slot ids must be unique — two "
                         "reloads landing in one slot is a plan bug")
    if dst_pool.device.type == "cpu":
        return dequantize_blocks_plain(dst_pool, values, scales, slot_ids,
                                       fidelity)
    ids = _ids_tensor(slot_ids, dst_pool.device)
    _check_kernel_operands("dequantize_blocks", dst_pool, ids, values,
                           scales)
    if values.dtype != FIDELITY_QDTYPE[fidelity] \
            or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_blocks: {fidelity} takes "
                        f"{FIDELITY_QDTYPE[fidelity]} values and f32 scales, "
                        f"got {values.dtype} / {scales.dtype}")
    lib = _kernels()
    dev = dst_pool.device
    with torch.cuda.device(dev):
        rc = lib.dequantize_reload(
            dst_pool.data_ptr(), ids.data_ptr(), m, elems, width,
            _FIDELITY_CODE[fidelity], values.data_ptr(), scales.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "dequantize_blocks")
    dequantize_blocks.launches += 1
    return dst_pool


#: kernel launches since the count was last set to 0
quantize_blocks.launches = 0
dequantize_blocks.launches = 0


# ---------------------------------------------------------------------------
# plain movers (no kernel on this slice's path)
# ---------------------------------------------------------------------------


def scatter_blocks(dst_pool, staging, slot_ids):
    """``dst_pool[slot_ids] = staging`` in place; returns ``dst_pool``."""
    _check_slot_ids(slot_ids, dst_pool.shape[0], "scatter_blocks")
    ids = _ids_tensor(slot_ids, dst_pool.device).long()
    dst_pool[ids] = staging.to(dst_pool.dtype)
    return dst_pool


def copy_blocks(src_pool, dst_pool, src_ids, dst_ids):
    """``dst_pool[dst_ids[i]] = src_pool[src_ids[i]]`` in place; returns
    ``dst_pool``."""
    if src_pool.shape[1:] != dst_pool.shape[1:]:
        raise ValueError(f"copy_blocks: pool block sizes differ: "
                         f"{tuple(src_pool.shape[1:])} vs "
                         f"{tuple(dst_pool.shape[1:])}")
    _check_slot_ids(src_ids, src_pool.shape[0], "copy_blocks(src)")
    _check_slot_ids(dst_ids, dst_pool.shape[0], "copy_blocks(dst)")
    sids = _ids_tensor(src_ids, src_pool.device).long()
    dids = _ids_tensor(dst_ids, dst_pool.device).long()
    dst_pool[dids] = src_pool[sids].to(dst_pool.dtype)
    return dst_pool
