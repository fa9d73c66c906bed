"""Expert FFN over capacity dispatch buffers (kernel K7,
``csrc/moe_ffn.cu``): ``out[e] = (act(x[e] @ wg[e]) * (x[e] @ wi[e])) @
wo[e]``.

``moe_ffn`` launches the kernel on CUDA tensors and runs its plain PyTorch
version, ``moe_ffn_plain``, on the CPU.  Both round where the JAX model's
``expert_ffn`` does (three einsums in the working dtype, the activation op
by op), so in bf16 they agree with it to a rounding step and in f32 with
the Pallas kernel ``repro/kernels/moe_ffn/kernel.py::moe_ffn``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.models.layers import _activation

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"silu": 0, "gelu": 1, "relu2": 2}


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.library("moe_ffn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_ffn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, p]
    lib.moe_ffn.restype = i
    lib.moe_ffn_error_string.argtypes = [i]
    lib.moe_ffn_error_string.restype = ctypes.c_char_p
    return lib


def _check(xd, wi, wg, wo, activation: str) -> None:
    if activation not in _ACT_CODE:
        raise ValueError(f"moe_ffn: unknown activation {activation!r} — one "
                         f"of {sorted(_ACT_CODE)}")
    if xd.ndim != 3:
        raise ValueError(f"moe_ffn: xd must be (E, C, d), got "
                         f"{tuple(xd.shape)}")
    e, _, d = xd.shape
    f = wi.shape[-1] if wi.ndim == 3 else -1
    want = {"wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
    for name, w in (("wi", wi), ("wg", wg), ("wo", wo)):
        if tuple(w.shape) != want[name]:
            raise ValueError(f"moe_ffn: {name} shape {tuple(w.shape)} != "
                             f"{want[name]} for xd {tuple(xd.shape)}")
    if any(w.dtype != xd.dtype for w in (wi, wg, wo)) \
            or xd.dtype not in _DTYPE_CODE:
        raise TypeError("moe_ffn: xd and the weights must share one dtype, "
                        "bf16 or f32; got "
                        f"{[t.dtype for t in (xd, wi, wg, wo)]}")
    if any(w.device != xd.device for w in (wi, wg, wo)):
        raise ValueError(f"moe_ffn: every operand must be on {xd.device}")


def moe_ffn_plain(xd, wi, wg, wo, activation: str = "silu"):
    """The JAX model's ``expert_ffn`` in PyTorch: each einsum sums in f32
    and rounds to the working dtype, as does each op of the activation."""
    act = _activation(activation)
    h = torch.einsum("ecd,edf->ecf", xd, wi)
    g = torch.einsum("ecd,edf->ecf", xd, wg)
    return torch.einsum("ecf,efd->ecd", act(g) * h, wo)


def moe_ffn(xd, wi, wg, wo, *, activation: str = "silu", skipped=None):
    """xd (E, C, d); wi, wg (E, d, f); wo (E, f, d) -> (E, C, d) in xd's
    dtype.  One call launches the kernel pair (gate-up, then down) and
    counts one launch.  An expert's tile of 16 dispatch rows that are all
    zero reads no weight and gives exact zeros.  ``skipped``: an optional
    one-element int32 tensor on the card to which the kernel adds the
    number of (expert, 16-row tile) pairs it skipped."""
    _check(xd, wi, wg, wo, activation)
    if skipped is not None and (skipped.device != xd.device
                                or skipped.dtype != torch.int32
                                or skipped.numel() != 1):
        raise ValueError("moe_ffn: skipped must be one int32 on "
                         f"{xd.device}")
    if xd.device.type == "cpu":
        return moe_ffn_plain(xd, wi, wg, wo, activation)
    refuse_grad("moe_ffn", xd, wi, wg, wo)
    if not all(t.is_contiguous() for t in (xd, wi, wg, wo)):
        raise ValueError("moe_ffn: operands must be contiguous")
    e, c, d = xd.shape
    f = wi.shape[-1]
    out = torch.empty_like(xd)
    if f == 0:
        return out.zero_()
    work = torch.empty((e, c, f), dtype=xd.dtype, device=xd.device)
    lib = _kernels()
    with torch.cuda.device(xd.device):
        rc = lib.moe_ffn(xd.data_ptr(), wi.data_ptr(), wg.data_ptr(),
                         wo.data_ptr(), work.data_ptr(), out.data_ptr(),
                         e, c, d, f, _DTYPE_CODE[xd.dtype],
                         _ACT_CODE[activation],
                         None if skipped is None else skipped.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("moe_ffn: launch failed: "
                           + lib.moe_ffn_error_string(rc).decode())
    moe_ffn.launches += 1
    return out


#: kernel launches since the count was last set to 0
moe_ffn.launches = 0
