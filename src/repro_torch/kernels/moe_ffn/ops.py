"""Expert FFN over capacity dispatch buffers (kernel K7,
``csrc/moe_ffn.cu``): ``out[e] = (act(x[e] @ wg[e]) * (x[e] @ wi[e])) @
wo[e]``, and its gradient.

``moe_ffn`` launches the kernel on CUDA tensors and runs its plain PyTorch
version, ``moe_ffn_plain``, on the CPU.  Both round where the JAX model's
``expert_ffn`` does (three einsums in the working dtype, the activation op
by op), so in bf16 they agree with it to a rounding step and in f32 with
the Pallas kernel ``repro/kernels/moe_ffn/kernel.py::moe_ffn``.

When grad mode is on and an operand requires grad, ``moe_ffn`` goes
through ``MoeFFN``, a ``torch.autograd.Function`` whose backward is
``moe_ffn_bwd``: the backward kernels on a CUDA tensor, ``moe_ffn_bwd_plain``
on the CPU.  The JAX package has no backward kernel (XLA differentiates
``expert_ffn``); this one computes that gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import _activation

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"silu": 0, "gelu": 1, "relu2": 2}


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.library("moe_ffn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_ffn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, p]
    lib.moe_ffn.restype = i
    lib.moe_ffn_bwd.argtypes = [p] * 13 + [i] * 7 + [p, p]
    lib.moe_ffn_bwd.restype = i
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


def _activation_grad(name: str):
    """d act(u) / du in f32 (the derivative of the forward's activation)."""
    def silu(u):
        s = 1 / (1 + torch.exp(-u))
        return s * (1 + u * (1 - s))

    def gelu(u):
        c = (2 / torch.pi) ** 0.5
        t = torch.tanh(c * (u + 0.044715 * (u * u * u)))
        return 0.5 * (1 + t) + 0.5 * u * (1 - t * t) * c \
            * (1 + 3 * 0.044715 * u * u)

    def relu2(u):
        return 2 * torch.relu(u)

    return {"silu": silu, "gelu": gelu, "relu2": relu2}[name]


def moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation: str = "silu"):
    """The gradient (dxd, dwi, dwg, dwo) of ``moe_ffn_plain`` at cotangent
    ``dout`` (E, C, d), rounding where the kernel rounds: h, g, act(g)
    and A = act(g) * h as the forward rounds them (recomputed from xd);
    dA = dout wo^T, dH = dA * act(g), dX = dH wi^T + dG wg^T (one f32 sum),
    dWi = xd^T dH, dWg = xd^T dG and dWo = A^T dout, each product summed in
    f32 and rounded once to the dtype; dG = dA * h * act'(g) in f32 from
    the rounded factors, rounded once.  In f32 the roundings vanish."""
    act = _activation(activation)
    h = torch.einsum("ecd,edf->ecf", xd, wi)
    g = torch.einsum("ecd,edf->ecf", xd, wg)
    ag = act(g)
    a = ag * h
    da = torch.einsum("ecd,efd->ecf", dout, wo)
    dh = da * ag
    dg = (da.float() * h.float()
          * _activation_grad(activation)(g.float())).to(xd.dtype)
    dx = (torch.einsum("ecf,edf->ecd", dh.float(), wi.float())
          + torch.einsum("ecf,edf->ecd", dg.float(), wg.float())
          ).to(xd.dtype)
    dwi = torch.einsum("ecd,ecf->edf", xd, dh)
    dwg = torch.einsum("ecd,ecf->edf", xd, dg)
    dwo = torch.einsum("ecf,ecd->efd", a, dout)
    return dx, dwi, dwg, dwo


def _check_skipped(skipped, xd) -> None:
    if skipped is not None and (skipped.device != xd.device
                                or skipped.dtype != torch.int32
                                or skipped.numel() != 1):
        raise ValueError("moe_ffn: skipped must be one int32 on "
                         f"{xd.device}")


def _launch(xd, wi, wg, wo, activation, skipped):
    """The forward kernel pair on CUDA tensors (one counted launch)."""
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


class MoeFFN(torch.autograd.Function):
    """``moe_ffn`` with a gradient.  The forward is the kernel pair on a
    CUDA tensor and the plain version on the CPU, and saves its four
    operands (h and g are recomputed in the backward, not saved); the
    backward is ``moe_ffn_bwd``.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass (a second launch)."""

    @staticmethod
    def forward(ctx, xd, wi, wg, wo, activation, skipped):
        if xd.device.type == "cpu":
            out = moe_ffn_plain(xd, wi, wg, wo, activation)
        else:
            out = _launch(xd, wi, wg, wo, activation, skipped)
        ctx.save_for_backward(xd, wi, wg, wo)
        ctx.activation = activation
        return out

    @staticmethod
    def backward(ctx, dout):
        xd, wi, wg, wo = ctx.saved_tensors
        grads = moe_ffn_bwd(xd, wi, wg, wo, dout.contiguous(),
                            activation=ctx.activation)
        return (*grads, None, None)


def moe_ffn(xd, wi, wg, wo, *, activation: str = "silu", skipped=None):
    """xd (E, C, d); wi, wg (E, d, f); wo (E, f, d) -> (E, C, d) in xd's
    dtype.  One call launches the kernel pair (gate-up, then down) and
    counts one launch.  An expert's tile of 16 dispatch rows that are all
    zero reads no weight and gives exact zeros.  ``skipped``: an optional
    one-element int32 tensor on the card to which the kernel adds the
    number of (expert, 16-row tile) pairs it skipped; it takes no part in
    the gradient.  With grad mode on and an operand requiring grad it goes
    through ``MoeFFN``, whose backward is a kernel too."""
    _check(xd, wi, wg, wo, activation)
    _check_skipped(skipped, xd)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xd, wi, wg, wo)):
        return MoeFFN.apply(xd, wi, wg, wo, activation, skipped)
    if xd.device.type == "cpu":
        return moe_ffn_plain(xd, wi, wg, wo, activation)
    return _launch(xd, wi, wg, wo, activation, skipped)


#: kernel launches since the count was last set to 0
moe_ffn.launches = 0

#: rows of a C tile of the backward kernels: the granularity of their skip
BWD_TILE = 64


def moe_ffn_bwd(xd, wi, wg, wo, dout, *, activation: str = "silu",
                skipped=None):
    """The gradient (dxd, dwi, dwg, dwo) of ``moe_ffn`` at cotangent
    ``dout`` (E, C, d).  On a CUDA tensor one call launches the backward's
    four kernels (A, dH and dG from recomputed h and g; dX; dWi and dWg;
    dWo: bf16 on the tensor cores, f32 on the CUDA cores) and counts one
    launch; no kernel adds with atomics, so a second call gives the same
    bits.  A 64-row tile of xd that is all zero adds nothing and is
    skipped; an expert without a token gets zero weight gradients without
    a weight being read.  ``skipped``: as ``moe_ffn``'s, counting (expert,
    64-row tile) pairs.  On the CPU it runs ``moe_ffn_bwd_plain``."""
    _check(xd, wi, wg, wo, activation)
    _check_skipped(skipped, xd)
    if dout.shape != xd.shape or dout.dtype != xd.dtype \
            or dout.device != xd.device:
        raise ValueError(f"moe_ffn_bwd: dout must be {tuple(xd.shape)} "
                         f"{xd.dtype} on {xd.device}; got "
                         f"{tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device}")
    if xd.device.type == "cpu":
        return moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation)
    if not all(t.is_contiguous() for t in (xd, wi, wg, wo, dout)):
        raise ValueError("moe_ffn_bwd: operands must be contiguous")
    e, c, d = xd.shape
    f = wi.shape[-1]
    dx, dwi, dwg, dwo = (torch.empty_like(t) for t in (xd, wi, wg, wo))
    if f == 0 or xd.numel() == 0:
        return tuple(t.zero_() for t in (dx, dwi, dwg, dwo))
    fp = -(-f // 8) * 8
    aw, dh, dg = (torch.empty((e, c, fp), dtype=xd.dtype, device=xd.device)
                  for _ in range(3))
    flags = torch.empty((e, -(-c // BWD_TILE)), dtype=torch.int32,
                        device=xd.device)
    lib = _kernels()
    with torch.cuda.device(xd.device):
        rc = lib.moe_ffn_bwd(
            xd.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), dwi.data_ptr(), dwg.data_ptr(),
            dwo.data_ptr(), aw.data_ptr(), dh.data_ptr(), dg.data_ptr(),
            flags.data_ptr(), e, c, d, f, fp, _DTYPE_CODE[xd.dtype],
            _ACT_CODE[activation],
            None if skipped is None else skipped.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("moe_ffn_bwd: launch failed: "
                           + lib.moe_ffn_error_string(rc).decode())
    moe_ffn_bwd.launches += 1
    return dx, dwi, dwg, dwo


#: backward calls (four kernels each) since the count was last set to 0
moe_ffn_bwd.launches = 0
