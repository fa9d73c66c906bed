"""Harvest block movers: the gather of pool rows into a staging buffer and
the fused copy of pool rows into pool rows (kernels K6 and K5,
``csrc/harvest_copy.cu``), quantize-on-demote and dequantize-on-reload
(kernels K2 and K3, ``csrc/harvest_quant.cu``), and the plain scatter.

``gather_blocks``, ``copy_blocks``, ``quantize_blocks`` and
``dequantize_blocks`` launch their kernel on a CUDA tensor and run their
plain PyTorch version (``*_plain``) on the CPU.  The checks of the JAX
wrappers are kept and raise the same exceptions: ``IndexError`` for slot
ids out of range, ``ValueError`` for an unknown fidelity or a bad shape,
``TypeError`` for a pool that is not floating.  On the card K2 and K3
take f32, bf16 and f16 pools (``KERNEL_POOL_DTYPES``) and raise
``TypeError`` on any other.  Ids may lie on the host or on the device.
Ids on the device are read back to be checked, which waits for the card,
unless the caller also passes ``host_ids``, a host mirror of them that the
checks read instead.  Every kernel here takes the ids of up to
``IDS_BY_VALUE`` rows in the launch itself, from the host copy: no id copy
to the card.  ``scatter_blocks`` is plain PyTorch on any device.

On ``meta`` tensors (ids on the host, or a ``host_ids`` mirror) each
wrapper returns outputs of its kernel's shapes and reports its cost
function's numbers (``kernels.kernel_call``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import (KernelCost, build, kernel_call,
                               refuse_grad)
from repro_torch.kernels.paged_attention.ops import sm_count

#: symmetric quantization range per wire fidelity (e4m3's largest finite
#: value is 448; int4 packs two's-complement nibbles, so +-7 keeps the
#: packing sign-safe)
FIDELITY_QMAX = {"int8": 127.0, "fp8": 448.0, "int4": 7.0}

#: storage dtype of the packed value plane per wire fidelity
FIDELITY_QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                   "int4": torch.uint8}

_FIDELITY_CODE = {"int8": 0, "fp8": 1, "int4": 2}

#: pool dtypes that K2 and K3 take on the card, by csrc's PoolType code
KERNEL_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the kernels pass the ids of up to this many rows in the launch (csrc's
#: kIdsByValue)
IDS_BY_VALUE = 128


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


def _checked_ids(slot_ids, host_ids, n_slots: int, what: str) -> np.ndarray:
    """The ids as a flat host array, range-checked: ``host_ids`` where the
    caller keeps a mirror of ``slot_ids`` (then device ids are not read
    back), else ``slot_ids`` itself."""
    if host_ids is None:
        host = _ids_host(slot_ids).reshape(-1)
    else:
        host = np.asarray(host_ids).reshape(-1)
        n = slot_ids.numel() if isinstance(slot_ids, torch.Tensor) \
            else np.size(slot_ids)
        if host.size != n:
            raise ValueError(f"{what}: host_ids holds {host.size} ids for "
                             f"{n} slot ids")
    _check_slot_ids(host, n_slots, what)
    return host


def _check_fidelity(fidelity: str, what: str) -> None:
    if fidelity not in FIDELITY_QMAX:
        raise ValueError(f"{what}: unknown fidelity {fidelity!r} — one of "
                         f"{sorted(FIDELITY_QMAX)}")


def _check_rows(pool, what: str) -> None:
    if getattr(pool, "ndim", None) != 2:
        raise ValueError(f"{what}: pool must be 2-D (n_slots, block_elems), "
                         f"got shape {tuple(getattr(pool, 'shape', ()))}")


def _check_pool(pool, what: str) -> None:
    _check_rows(pool, what)
    if not pool.dtype.is_floating_point:
        raise TypeError(f"{what}: pool dtype {pool.dtype} is not floating — "
                        "quantization needs a full-precision source")


def _ids_tensor(slot_ids, device) -> torch.Tensor:
    ids = slot_ids if isinstance(slot_ids, torch.Tensor) \
        else torch.as_tensor(np.asarray(slot_ids))
    return ids.to(device=device, dtype=torch.int32).contiguous()


def _same_start(a, b) -> bool:
    """``a`` and ``b`` start at one address (on ``meta``, where every
    address is 0: in one storage at one offset)."""
    if a.device.type == "meta":
        return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
                and a.storage_offset() == b.storage_offset())
    return a.data_ptr() == b.data_ptr()


def _check_device_operands(what: str, device, *tensors) -> None:
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what}: every operand must be on {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")


def _check_kernel_operands(what: str, pool, *tensors) -> None:
    if pool.dtype not in KERNEL_POOL_DTYPES:
        raise TypeError(f"{what}: the kernel takes an f32, bf16 or f16 pool, "
                        f"got {pool.dtype}")
    _check_device_operands(what, pool.device, pool, *tensors)
    if pool.shape[1] == 0:
        raise ValueError(f"{what}: empty block rows")


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.library("harvest_quant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quantize_demote.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p]
    lib.quantize_demote.restype = i
    lib.quantize_demote_state_bytes.argtypes = []
    lib.quantize_demote_state_bytes.restype = i
    lib.dequantize_reload.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p]
    lib.dequantize_reload.restype = i
    lib.harvest_quant_error_string.argtypes = [i]
    lib.harvest_quant_error_string.restype = ctypes.c_char_p
    return lib


_EXCHANGE = {}


def _exchange_state(lib, stream) -> torch.Tensor:
    """Where K2's blocks exchange their maxima on ``stream``: zeroed once,
    then carried from launch to launch (each launch's epoch is one past
    the last).  One per stream, since launches on one stream never
    overlap."""
    key = (stream.device, stream.cuda_stream)
    if key not in _EXCHANGE:
        _EXCHANGE[key] = torch.zeros((lib.quantize_demote_state_bytes(),),
                                     dtype=torch.uint8, device=stream.device)
    return _EXCHANGE[key]


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


def quantize_blocks(src_pool, slot_ids, *, fidelity: str = "int8",
                    host_ids=None):
    """Quantize-on-demote: pack ``src_pool[slot_ids]`` into the wire
    fidelity's ``(values (m, width), scales (m, 1) f32)`` pair.
    ``host_ids``: an optional host mirror of ``slot_ids`` for the checks."""
    _check_fidelity(fidelity, "quantize_blocks")
    _check_pool(src_pool, "quantize_blocks")
    host = _checked_ids(slot_ids, host_ids, src_pool.shape[0],
                        "quantize_blocks")
    m, elems = host.size, src_pool.shape[1]
    width = _packed_width(elems, fidelity)
    with kernel_call("quantize_blocks", quantize_blocks_cost(
            m, elems, width, src_pool.element_size())):
        if src_pool.device.type == "cpu":
            return quantize_blocks_plain(src_pool, slot_ids, fidelity)
        if src_pool.device.type == "meta":
            return (torch.empty((m, width), dtype=FIDELITY_QDTYPE[fidelity],
                                device="meta"),
                    torch.empty((m, 1), dtype=torch.float32, device="meta"))
        return _quantize_launch(src_pool, slot_ids, host, fidelity)


def _quantize_launch(src_pool, slot_ids, host, fidelity):
    """K2 on a CUDA pool (one counted launch)."""
    refuse_grad("quantize_blocks", src_pool)
    m, elems = host.size, src_pool.shape[1]
    # the ids ride in the launch: no id copy to the card, and no load
    # between the launch and the rows
    by_value = m <= IDS_BY_VALUE
    host = np.ascontiguousarray(host, dtype=np.int32)
    ids = None if by_value else _ids_tensor(slot_ids, src_pool.device)
    _check_kernel_operands("quantize_blocks", src_pool,
                           *(() if by_value else (ids,)))
    width = _packed_width(elems, fidelity)
    dev = src_pool.device
    values = torch.empty((m, width), dtype=FIDELITY_QDTYPE[fidelity],
                         device=dev)
    scales = torch.empty((m, 1), dtype=torch.float32, device=dev)
    lib = _kernels()
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        rc = lib.quantize_demote(
            src_pool.data_ptr(), None if by_value else ids.data_ptr(),
            host.ctypes.data if by_value else None, m, elems, width,
            _FIDELITY_CODE[fidelity], KERNEL_POOL_DTYPES[src_pool.dtype],
            sm_count(dev),
            _exchange_state(lib, stream).data_ptr(), values.data_ptr(),
            scales.data_ptr(), stream.cuda_stream)
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
                      fidelity: str = "int8", host_ids=None):
    """Dequantize-on-reload into ``dst_pool[slot_ids]``, in place (the
    JAX kernel aliases its output to the pool; here the pool is updated
    where it lies).  ``slot_ids`` must be unique.  ``host_ids``: an
    optional host mirror of ``slot_ids`` for the checks.  Returns
    ``dst_pool``."""
    _check_fidelity(fidelity, "dequantize_blocks")
    _check_pool(dst_pool, "dequantize_blocks")
    host_ids = _checked_ids(slot_ids, host_ids, dst_pool.shape[0],
                            "dequantize_blocks")
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
    with kernel_call("dequantize_blocks", dequantize_blocks_cost(
            m, elems, width, dst_pool.element_size())):
        if dst_pool.device.type == "cpu":
            return dequantize_blocks_plain(dst_pool, values, scales,
                                           slot_ids, fidelity)
        if dst_pool.device.type == "meta":
            return dst_pool
        return _dequantize_launch(dst_pool, values, scales, slot_ids,
                                  host_ids, fidelity, width)


def _dequantize_launch(dst_pool, values, scales, slot_ids, host_ids,
                       fidelity, width):
    """K3 into a CUDA pool (one counted launch)."""
    m, elems = host_ids.shape[0], dst_pool.shape[1]
    refuse_grad("dequantize_blocks", dst_pool, values, scales)
    dev = dst_pool.device
    # the ids ride in the launch: no id copy to the card, and no load
    # between the launch and the rows
    by_value = m <= IDS_BY_VALUE
    host_ids = np.ascontiguousarray(host_ids, dtype=np.int32)
    ids = None if by_value else _ids_tensor(slot_ids, dev)
    _check_kernel_operands("dequantize_blocks", dst_pool, values, scales,
                           *(() if by_value else (ids,)))
    if values.dtype != FIDELITY_QDTYPE[fidelity] \
            or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_blocks: {fidelity} takes "
                        f"{FIDELITY_QDTYPE[fidelity]} values and f32 scales, "
                        f"got {values.dtype} / {scales.dtype}")
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.dequantize_reload(
            dst_pool.data_ptr(), None if by_value else ids.data_ptr(),
            host_ids.ctypes.data if by_value else None, m, elems, width,
            _FIDELITY_CODE[fidelity], KERNEL_POOL_DTYPES[dst_pool.dtype],
            sm_count(dev), values.data_ptr(), scales.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "dequantize_blocks")
    dequantize_blocks.launches += 1
    return dst_pool


#: kernel launches since the count was last set to 0
quantize_blocks.launches = 0
dequantize_blocks.launches = 0


def quantize_blocks_cost(m: int, elems: int, width: int,
                         itemsize: int) -> KernelCost:
    """One K2 call's least work: ``m`` rows of ``elems`` values read once,
    their packed ``width`` bytes and f32 scale written once; 3 f32 flops
    a value (the absmax, the scaling, the rounding)."""
    return KernelCost(3 * elems * m, m * (elems * itemsize + width + 4),
                      torch.float32)


def dequantize_blocks_cost(m: int, elems: int, width: int,
                           itemsize: int) -> KernelCost:
    """One K3 call's least work: ``m`` rows of ``width`` packed bytes and
    their f32 scale read once, their ``elems`` values written once; 3 f32
    flops a value (unpack, convert, scale)."""
    return KernelCost(3 * elems * m, m * (width + 4 + elems * itemsize),
                      torch.float32)


# ---------------------------------------------------------------------------
# K6 gather and K5 fused copy
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _movers():
    lib = build.library("harvest_copy")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.harvest_gather_rows.argtypes = [p, p, p, p, i, ll, ll, p]
    lib.harvest_gather_rows.restype = i
    lib.harvest_copy_rows.argtypes = [p, p, p, p, p, i, ll, i, p]
    lib.harvest_copy_rows.restype = i
    lib.harvest_copy_error_string.argtypes = [i]
    lib.harvest_copy_error_string.restype = ctypes.c_char_p
    return lib


def _launch_mover(what: str, fn, *args) -> None:
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed: "
                           + _movers().harvest_copy_error_string(rc).decode())


def gather_blocks_plain(src_pool, slot_ids, out=None):
    """``src_pool[slot_ids]`` as a new (m, block_elems) staging buffer, or
    written into ``out``."""
    rows = src_pool[_ids_tensor(slot_ids, src_pool.device).long()]
    return rows if out is None else out.copy_(rows)


def _rows_contiguous(t) -> bool:
    """Each row of the 2-D ``t`` is contiguous and the rows do not overlap
    (they may lie further apart: a half of the engine's payload)."""
    m, w = t.shape
    return (w <= 1 or t.stride(1) == 1) and (m <= 1 or t.stride(0) >= w)


def gather_blocks(src_pool, slot_ids, out=None, *, host_ids=None):
    """Gather rows ``slot_ids`` of ``src_pool`` (any dtype) into an
    (m, block_elems) staging buffer: a new one, or ``out``, of the pool's
    dtype and device, whose rows must each be contiguous but may lie
    further apart.  ``host_ids``: an optional host mirror of ``slot_ids``
    for the checks.  Returns the buffer."""
    _check_rows(src_pool, "gather_blocks")
    host = _checked_ids(slot_ids, host_ids, src_pool.shape[0],
                        "gather_blocks")
    m = host.size
    if out is not None:
        if tuple(out.shape) != (m, src_pool.shape[1]) \
                or out.dtype != src_pool.dtype:
            raise ValueError(
                f"gather_blocks: out is {out.dtype} {tuple(out.shape)}, "
                f"the gather gives {src_pool.dtype} "
                f"{(m, src_pool.shape[1])}")
        if not _rows_contiguous(out):
            raise ValueError("gather_blocks: out's rows must be contiguous "
                             "and must not overlap")
    row_bytes = src_pool.shape[1] * src_pool.element_size()
    with kernel_call("gather_blocks", gather_blocks_cost(m, row_bytes)):
        if src_pool.device.type == "cpu":
            return gather_blocks_plain(src_pool, slot_ids, out)
        if src_pool.device.type == "meta":
            return out if out is not None else torch.empty(
                (m, src_pool.shape[1]), dtype=src_pool.dtype, device="meta")
        return _gather_launch(src_pool, slot_ids, out, host)


def _gather_launch(src_pool, slot_ids, out, host):
    """K6 from a CUDA pool (one counted launch)."""
    m = host.size
    refuse_grad("gather_blocks", src_pool, out)
    dev = src_pool.device
    # the ids ride in the launch: no id copy to the card, and no load
    # between the launch and the rows
    by_value = m <= IDS_BY_VALUE
    host = np.ascontiguousarray(host, dtype=np.int32)
    ids = None if by_value else _ids_tensor(slot_ids, dev)
    if out is None:
        out = torch.empty((m, src_pool.shape[1]), dtype=src_pool.dtype,
                          device=dev)
    _check_device_operands("gather_blocks", dev, src_pool,
                           *(() if by_value else (ids,)))
    if out.device != dev:
        raise ValueError(f"gather_blocks: every operand must be on {dev}")
    if out.numel() == 0:
        return out
    row_bytes = src_pool.shape[1] * src_pool.element_size()
    stride = out.stride(0) * out.element_size() if m > 1 else row_bytes
    with torch.cuda.device(dev):
        _launch_mover("gather_blocks", _movers().harvest_gather_rows,
                      src_pool.data_ptr(),
                      None if by_value else ids.data_ptr(),
                      host.ctypes.data if by_value else None,
                      out.data_ptr(), m, row_bytes, stride)
    gather_blocks.launches += 1
    return out


def copy_blocks_plain(src_pool, dst_pool, src_ids, dst_ids):
    """``dst_pool[dst_ids[i]] = src_pool[src_ids[i]]`` in place; returns
    ``dst_pool``."""
    sids = _ids_tensor(src_ids, src_pool.device).long()
    dids = _ids_tensor(dst_ids, dst_pool.device).long()
    dst_pool[dids] = src_pool[sids]
    return dst_pool


def copy_blocks(src_pool, dst_pool, src_ids, dst_ids):
    """Fused gather->scatter ``dst_pool[dst_ids[i]] = src_pool[src_ids[i]]``
    in place, with no staging buffer; rows outside ``dst_ids`` keep their
    bytes.  Both pools share dtype and row size and may be one tensor.
    Destinations must be unique, and with one pool no row may be both read
    and written: either would make the result depend on the order of the
    writes.  Returns ``dst_pool``."""
    _check_rows(src_pool, "copy_blocks(src)")
    _check_rows(dst_pool, "copy_blocks(dst)")
    if src_pool.shape[1:] != dst_pool.shape[1:]:
        raise ValueError(f"copy_blocks: pool block sizes differ: "
                         f"{tuple(src_pool.shape[1:])} vs "
                         f"{tuple(dst_pool.shape[1:])}")
    if src_pool.dtype != dst_pool.dtype:
        raise TypeError(f"copy_blocks: pool dtypes differ: {src_pool.dtype} "
                        f"vs {dst_pool.dtype}")
    _check_slot_ids(src_ids, src_pool.shape[0], "copy_blocks(src)")
    _check_slot_ids(dst_ids, dst_pool.shape[0], "copy_blocks(dst)")
    sh, dh = _ids_host(src_ids).reshape(-1), _ids_host(dst_ids).reshape(-1)
    if sh.shape != dh.shape:
        raise ValueError(f"copy_blocks: id list shapes differ: {sh.shape} "
                         f"vs {dh.shape}")
    if np.unique(dh).size != dh.size:
        raise ValueError("copy_blocks: destination ids must be unique")
    if _same_start(src_pool, dst_pool) and np.intersect1d(sh, dh).size:
        raise ValueError("copy_blocks: a row is both read and written in "
                         "one pool; the copy would race")
    with kernel_call("copy_blocks", copy_blocks_cost(
            dh.size, src_pool.shape[1] * src_pool.element_size())):
        if dst_pool.device.type == "cpu":
            return copy_blocks_plain(src_pool, dst_pool, src_ids, dst_ids)
        if dst_pool.device.type == "meta":
            return dst_pool
        return _copy_launch(src_pool, dst_pool, sh, dh)


def _copy_launch(src_pool, dst_pool, sh, dh):
    """K5 between CUDA pools (one counted launch)."""
    refuse_grad("copy_blocks", src_pool, dst_pool)
    if dh.size == 0 or dst_pool.shape[1] == 0:
        return dst_pool
    dev = dst_pool.device
    # the (src, dst) id pairs ride in the launch: no id copy to the card;
    # more rows than that read one device table, src ids then dst ids
    m = dh.size
    by_value = m <= IDS_BY_VALUE
    sh = np.ascontiguousarray(sh, dtype=np.int32)
    dh = np.ascontiguousarray(dh, dtype=np.int32)
    ids = None if by_value else _ids_tensor(np.concatenate([sh, dh]), dev)
    _check_device_operands("copy_blocks", dev, src_pool, dst_pool,
                           *(() if by_value else (ids,)))
    with torch.cuda.device(dev):
        _launch_mover("copy_blocks", _movers().harvest_copy_rows,
                      src_pool.data_ptr(), dst_pool.data_ptr(),
                      None if by_value else ids.data_ptr(),
                      sh.ctypes.data if by_value else None,
                      dh.ctypes.data if by_value else None, m,
                      src_pool.shape[1] * src_pool.element_size(),
                      sm_count(dev))
    copy_blocks.launches += 1
    return dst_pool


gather_blocks.launches = 0
copy_blocks.launches = 0


def gather_blocks_cost(m: int, row_bytes: int) -> KernelCost:
    """One K6 call's least work: ``m`` rows of ``row_bytes`` read and
    written once, their int32 ids read; no arithmetic."""
    return KernelCost(0, 2 * m * row_bytes + 4 * m, torch.float32)


def copy_blocks_cost(m: int, row_bytes: int) -> KernelCost:
    """One K5 call's least work: ``m`` rows of ``row_bytes`` read and
    written once, their (src, dst) int32 id pairs read; no arithmetic."""
    return KernelCost(0, 2 * m * row_bytes + 8 * m, torch.float32)


# ---------------------------------------------------------------------------
# plain scatter (no kernel: the JAX package's harvest_scatter is a jnp
# scatter, not a Pallas kernel)
# ---------------------------------------------------------------------------


def scatter_blocks(dst_pool, staging, slot_ids):
    """``dst_pool[slot_ids] = staging`` in place; returns ``dst_pool``."""
    _check_slot_ids(slot_ids, dst_pool.shape[0], "scatter_blocks")
    ids = _ids_tensor(slot_ids, dst_pool.device).long()
    dst_pool[ids] = staging.to(dst_pool.dtype)
    return dst_pool
