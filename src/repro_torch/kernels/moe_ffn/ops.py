"""Expert FFN over capacity dispatch buffers (kernel K7,
``csrc/moe_ffn.cu``): ``out[e] = (act(x[e] @ wg[e]) * (x[e] @ wi[e])) @
wo[e]``, and its gradient.

``moe_ffn`` launches the kernel on CUDA tensors and runs its plain PyTorch
version, ``moe_ffn_plain``, on the CPU.  Both round where the JAX model's
``expert_ffn`` does (three einsums in the working dtype, the activation op
by op), so in bf16 they agree with it to a rounding step and in f32 with
the Pallas kernel ``repro/kernels/moe_ffn/kernel.py::moe_ffn``.

When grad mode is on and an operand requires grad, ``moe_ffn`` goes
through ``MoeFFN``, a ``torch.autograd.Function``.  On a CUDA bf16 tensor
its forward is ``moe_ffn_train``, the training forward (128-row tiles on
wgmma), which also keeps A = act(g) * h, h and g, and its backward the
kernels that read them instead of recomputing h and g; every call without
a gradient keeps the decode kernels.  In f32 the forward is the decode
kernels' and the backward ``moe_ffn_bwd`` recomputes h and g.  On the CPU
the plain forward returns (A, h, g) beside its output and the plain
backward consumes them.  The JAX package has no backward kernel (XLA
differentiates ``expert_ffn``); these compute that gradient.

On a ``meta`` tensor every wrapper returns outputs of its kernels' shapes
(and ``moe_ffn_train`` what the card's forward saves) and reports its cost
function's numbers (``kernels.kernel_call``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import KernelCost, build, kernel_call
from repro_torch.models.layers import _activation

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"silu": 0, "gelu": 1, "relu2": 2}


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.library("moe_ffn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_ffn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, p]
    lib.moe_ffn.restype = i
    lib.moe_ffn_train.argtypes = [p] * 13 + [i] * 5 + [p, p]
    lib.moe_ffn_train.restype = i
    lib.moe_ffn_bwd_train.argtypes = [p] * 16 + [i] * 5 + [p, p]
    lib.moe_ffn_bwd_train.restype = i
    lib.moe_ffn_bwd.argtypes = [p] * 13 + [i] * 6 + [p, p]
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


def _plain_residuals(xd, wi, wg, activation):
    act = _activation(activation)
    h = torch.einsum("ecd,edf->ecf", xd, wi)
    g = torch.einsum("ecd,edf->ecf", xd, wg)
    return act(g) * h, h, g


def moe_ffn_plain(xd, wi, wg, wo, activation: str = "silu", *,
                  residuals: bool = False):
    """The JAX model's ``expert_ffn`` in PyTorch: each einsum sums in f32
    and rounds to the working dtype, as does each op of the activation.
    ``residuals``: return ``(out, (A, h, g))``, the rounded h = xd wi,
    g = xd wg and A = act(g) * h that the backward reads."""
    a, h, g = _plain_residuals(xd, wi, wg, activation)
    out = torch.einsum("ecf,efd->ecd", a, wo)
    return (out, (a, h, g)) if residuals else out


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


def moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation: str = "silu", *,
                      saved=None):
    """The gradient (dxd, dwi, dwg, dwo) of ``moe_ffn_plain`` at cotangent
    ``dout`` (E, C, d), rounding where the kernel rounds: h, g, act(g)
    and A = act(g) * h as the forward rounds them (recomputed from xd, or
    ``saved``: the ``(A, h, g)`` of ``moe_ffn_plain(..., residuals=True)``,
    which gives the same bits); dA = dout wo^T, dH = dA * act(g),
    dX = dH wi^T + dG wg^T (one f32 sum), dWi = xd^T dH, dWg = xd^T dG and
    dWo = A^T dout, each product summed in f32 and rounded once to the
    dtype; dG = dA * h * act'(g) in f32 from the rounded factors, rounded
    once.  In f32 the roundings vanish."""
    a, h, g = saved if saved is not None else _plain_residuals(
        xd, wi, wg, activation)
    ag = _activation(activation)(g)
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


#: rows of a C tile of the bf16 training kernels (the training forward and
#: the bf16 backward): the granularity of their flags and of their skip
TRAIN_TILE = 128
#: rows of a C tile of the f32 backward kernels
F32_BWD_TILE = 64


def bwd_tile(dtype) -> int:
    """Rows of the C tiles that ``moe_ffn_bwd`` skips and counts in
    ``dtype``."""
    return TRAIN_TILE if dtype == torch.bfloat16 else F32_BWD_TILE


def _padded_like(t):
    """None if TMA can read ``t`` as it is (rows of a multiple of 8 values,
    its start on 16 bytes), else a workspace of its shape with rows of the
    next multiple of 8, which the kernels fill with it and zero columns."""
    w = t.shape[-1]
    if w % 8 == 0 and t.data_ptr() % 16 == 0:
        return None
    return torch.empty((*t.shape[:-1], -(-w // 8) * 8), dtype=t.dtype,
                       device=t.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _train_launch(xd, wi, wg, wo, activation, skipped):
    """The bf16 training forward on CUDA tensors (not counted).  Returns
    (out, saved): saved is what the backward reads, (x, wi, wg, wo as the
    kernels read them (their rows padded to 8 values where they were not),
    A, h, g (E, C, fp), the C tiles' flags (E, ceil(C / 128)))."""
    if not all(t.is_contiguous() for t in (xd, wi, wg, wo)):
        raise ValueError("moe_ffn: operands must be contiguous")
    e, c, d = xd.shape
    f = wi.shape[-1]
    fp = -(-f // 8) * 8
    pads = [_padded_like(t) for t in (xd, wi, wg, wo)]
    out = torch.empty_like(xd)
    aw, hw, gw = (torch.empty((e, c, fp), dtype=xd.dtype, device=xd.device)
                  for _ in range(3))
    flags = torch.empty((e, -(-c // TRAIN_TILE)), dtype=torch.int32,
                        device=xd.device)
    saved = (*(t if pad is None else pad
               for t, pad in zip((xd, wi, wg, wo), pads)), aw, hw, gw, flags)
    if f == 0 or xd.numel() == 0:
        for t in (out, aw, hw, gw, flags):
            t.zero_()
        return out, saved
    lib = _kernels()
    with torch.cuda.device(xd.device):
        rc = lib.moe_ffn_train(
            xd.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
            *(_ptr(t) for t in pads), aw.data_ptr(), hw.data_ptr(),
            gw.data_ptr(), flags.data_ptr(), out.data_ptr(), e, c, d, f,
            _ACT_CODE[activation],
            None if skipped is None else skipped.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("moe_ffn_train: launch failed: "
                           + lib.moe_ffn_error_string(rc).decode())
    return out, saved


def moe_ffn_train(xd, wi, wg, wo, *, activation: str = "silu",
                  skipped=None):
    """The forward that a training step runs, and what its backward
    (``moe_ffn_bwd_saved``) reads.  On a bf16 CUDA tensor one call
    launches the pads of the operands whose rows TMA cannot read, the
    flags pass, gate-up and down (128-row C tiles on wgmma) and counts one
    launch; a 128-row tile of xd that is all zero reads no weight and
    gives zeros, and ``skipped`` (as ``moe_ffn``'s) counts those (expert,
    128-row tile) pairs.  On the CPU the plain forward, saving (xd, wi,
    wg, wo, A, h, g).  f32 on the card trains on ``moe_ffn``'s kernels."""
    _check(xd, wi, wg, wo, activation)
    _check_skipped(skipped, xd)
    with kernel_call("moe_ffn_train", moe_ffn_train_cost(*_dims(xd, wi),
                                                         xd.element_size())):
        if xd.device.type == "cpu":
            out, res = moe_ffn_plain(xd, wi, wg, wo, activation,
                                     residuals=True)
            return out, (xd, wi, wg, wo, *res)
        if xd.device.type == "meta":
            return _meta_train(xd, wi, wg, wo)
        if xd.dtype != torch.bfloat16:
            raise ValueError("moe_ffn_train: takes bf16 on the card; got "
                             f"{xd.dtype}")
        out, saved = _train_launch(xd, wi, wg, wo, activation, skipped)
        moe_ffn_train.launches += 1
        return out, saved


def _meta_train(xd, wi, wg, wo):
    """``_train_launch``'s outputs on ``meta``: the output, and what the
    card's forward saves (the operands as they are, A, h and g of rows
    padded to 8 values, the 128-row tiles' flags)."""
    e, c, _ = xd.shape
    fp = -(-wi.shape[-1] // 8) * 8
    aw, hw, gw = (torch.empty((e, c, fp), dtype=xd.dtype, device="meta")
                  for _ in range(3))
    flags = torch.empty((e, -(-c // TRAIN_TILE)), dtype=torch.int32,
                        device="meta")
    return torch.empty_like(xd), (xd, wi, wg, wo, aw, hw, gw, flags)


#: kernel launches since the count was last set to 0
moe_ffn_train.launches = 0


def moe_ffn_bwd_saved(saved, dout, *, activation: str = "silu",
                      skipped=None):
    """The gradient (dxd, dwi, dwg, dwo) at cotangent ``dout`` (E, C, d)
    from what ``moe_ffn_train`` saved.  On the card (bf16) one call
    launches the backward's four kernels on wgmma (dA with dH and dG from
    the saved h and g; dX; dWi and dWg; dWo) and counts one
    ``moe_ffn_bwd`` launch; ``skipped`` counts the (expert, 128-row tile)
    pairs without a token.  On the CPU ``moe_ffn_bwd_plain`` on the saved
    A, h and g."""
    e, c, d = dout.shape
    f = saved[3].shape[1]           # wo's rows: the unpadded width
    with kernel_call("moe_ffn_bwd", moe_ffn_bwd_cost(
            e, c, d, f, dout.element_size(), saved=True)):
        if dout.device.type == "cpu":
            xd, wi, wg, wo, *res = saved
            return moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation,
                                     saved=res)
        if dout.device.type == "meta":
            return _meta_grads(dout, f)
        return _bwd_saved_launch(saved, dout, activation, skipped)


def _meta_grads(xd, f):
    """(dxd, dwi, dwg, dwo) of xd's experts and width ``f`` on ``meta``."""
    e, c, d = xd.shape
    return (torch.empty((e, c, d), dtype=xd.dtype, device="meta"),
            *(torch.empty(shape, dtype=xd.dtype, device="meta")
              for shape in ((e, d, f), (e, d, f), (e, f, d))))


def _bwd_saved_launch(saved, dout, activation, skipped):
    """``moe_ffn_bwd_saved``'s launch on CUDA tensors (one counted)."""
    xp, wip, wgp, wop, aw, hw, gw, flags = saved
    e, c, _ = xp.shape
    d, fp = wip.shape[1:]
    f = wop.shape[1]
    if activation not in _ACT_CODE:
        raise ValueError(f"moe_ffn_bwd_saved: unknown activation "
                         f"{activation!r}")
    _check_skipped(skipped, dout)
    if dout.shape != (e, c, d) or dout.dtype != torch.bfloat16 \
            or dout.device != xp.device:
        raise ValueError(f"moe_ffn_bwd_saved: dout {tuple(dout.shape)} "
                         f"{dout.dtype} does not match the saved forward")
    dx = torch.empty((e, c, d), dtype=xp.dtype, device=xp.device)
    dwi, dwg = (torch.empty((e, d, f), dtype=xp.dtype, device=xp.device)
                for _ in range(2))
    dwo = torch.empty((e, f, d), dtype=xp.dtype, device=xp.device)
    if f == 0 or dx.numel() == 0:
        return tuple(t.zero_() for t in (dx, dwi, dwg, dwo))
    dout = dout.contiguous()
    dyp = _padded_like(dout)
    dh, dg = (torch.empty((e, c, fp), dtype=xp.dtype, device=xp.device)
              for _ in range(2))
    lib = _kernels()
    with torch.cuda.device(xp.device):
        rc = lib.moe_ffn_bwd_train(
            xp.data_ptr(), wip.data_ptr(), wgp.data_ptr(), wop.data_ptr(),
            aw.data_ptr(), hw.data_ptr(), gw.data_ptr(), flags.data_ptr(),
            dout.data_ptr(), _ptr(dyp), dh.data_ptr(), dg.data_ptr(),
            dx.data_ptr(), dwi.data_ptr(), dwg.data_ptr(), dwo.data_ptr(),
            e, c, d, f, _ACT_CODE[activation],
            None if skipped is None else skipped.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("moe_ffn_bwd: launch failed: "
                           + lib.moe_ffn_error_string(rc).decode())
    moe_ffn_bwd.launches += 1
    return dx, dwi, dwg, dwo


class MoeFFN(torch.autograd.Function):
    """``moe_ffn`` with a gradient.  On the CPU and on a CUDA bf16 tensor
    the forward is ``moe_ffn_train``, which saves what its backward
    ``moe_ffn_bwd_saved`` reads (A, h and g instead of a recompute; on the
    card also the padded operands and the tiles' flags); in f32 on the
    card it is the decode kernels, saving the operands for ``moe_ffn_bwd``,
    which recomputes h and g.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass (a second launch), and what it
    saves lives only until that block's backward."""

    @staticmethod
    def forward(ctx, xd, wi, wg, wo, activation, skipped):
        ctx.activation = activation
        ctx.kept = xd.device.type == "cpu" or xd.dtype == torch.bfloat16
        if ctx.kept:
            out, saved = moe_ffn_train(xd, wi, wg, wo, activation=activation,
                                       skipped=skipped)
            ctx.save_for_backward(*saved)
        else:
            with kernel_call("moe_ffn", _ffn_cost(xd, wi)):
                out = torch.empty_like(xd) if xd.device.type == "meta" \
                    else _launch(xd, wi, wg, wo, activation, skipped)
            ctx.save_for_backward(xd, wi, wg, wo)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        if ctx.kept:
            grads = moe_ffn_bwd_saved(saved, dout, activation=ctx.activation)
        else:
            grads = moe_ffn_bwd(*saved, dout.contiguous(),
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
    through ``MoeFFN`` (in bf16 on the card the training forward, counted
    as ``moe_ffn_train``'s launch, its tiles 128 rows), whose backward is
    a kernel too."""
    _check(xd, wi, wg, wo, activation)
    _check_skipped(skipped, xd)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xd, wi, wg, wo)):
        return MoeFFN.apply(xd, wi, wg, wo, activation, skipped)
    with kernel_call("moe_ffn", _ffn_cost(xd, wi)):
        if xd.device.type == "cpu":
            return moe_ffn_plain(xd, wi, wg, wo, activation)
        if xd.device.type == "meta":
            return torch.empty_like(xd)
        return _launch(xd, wi, wg, wo, activation, skipped)


#: kernel launches since the count was last set to 0
moe_ffn.launches = 0


def moe_ffn_bwd(xd, wi, wg, wo, dout, *, activation: str = "silu",
                skipped=None):
    """The gradient (dxd, dwi, dwg, dwo) of ``moe_ffn`` at cotangent
    ``dout`` (E, C, d).  On a CUDA tensor one call counts one launch.  In
    bf16 it launches the training forward (for A, h and g) and then the
    backward's four kernels on wgmma (dA with dH and dG; dX; dWi and dWg;
    dWo); in f32 four kernels on the CUDA cores that recompute h and g
    first.  No kernel adds with atomics, so a second call gives the same
    bits.  A C tile of xd that is all zero (128 rows in bf16, 64 in f32:
    ``bwd_tile``) adds nothing and is skipped; an expert without a token
    gets zero weight gradients without a weight being read.  ``skipped``:
    as ``moe_ffn``'s, counting the backward's (expert, tile) pairs.  On
    the CPU it runs ``moe_ffn_bwd_plain``."""
    _check(xd, wi, wg, wo, activation)
    _check_skipped(skipped, xd)
    if dout.shape != xd.shape or dout.dtype != xd.dtype \
            or dout.device != xd.device:
        raise ValueError(f"moe_ffn_bwd: dout must be {tuple(xd.shape)} "
                         f"{xd.dtype} on {xd.device}; got "
                         f"{tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device}")
    e, c, d = xd.shape
    f = wi.shape[-1]
    if xd.device.type == "cuda" and xd.dtype == torch.bfloat16:
        if not all(t.is_contiguous() for t in (xd, wi, wg, wo, dout)):
            raise ValueError("moe_ffn_bwd: operands must be contiguous")
        # the training forward (uncounted), then the backward that reads
        # it, which counts and reports itself
        _, saved = _train_launch(xd, wi, wg, wo, activation, None)
        return moe_ffn_bwd_saved(saved, dout, activation=activation,
                                 skipped=skipped)
    with kernel_call("moe_ffn_bwd", moe_ffn_bwd_cost(
            e, c, d, f, xd.element_size(), saved=False)):
        if xd.device.type == "cpu":
            return moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation)
        if xd.device.type == "meta":
            return _meta_grads(xd, f)
        return _bwd_launch_f32(xd, wi, wg, wo, dout, activation, skipped)


def _bwd_launch_f32(xd, wi, wg, wo, dout, activation, skipped):
    """``moe_ffn_bwd``'s f32 kernels on CUDA tensors (one counted)."""
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
    flags = torch.empty((e, -(-c // F32_BWD_TILE)), dtype=torch.int32,
                        device=xd.device)
    lib = _kernels()
    with torch.cuda.device(xd.device):
        rc = lib.moe_ffn_bwd(
            xd.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), dwi.data_ptr(), dwg.data_ptr(),
            dwo.data_ptr(), aw.data_ptr(), dh.data_ptr(), dg.data_ptr(),
            flags.data_ptr(), e, c, d, f, fp, _ACT_CODE[activation],
            None if skipped is None else skipped.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("moe_ffn_bwd: launch failed: "
                           + lib.moe_ffn_error_string(rc).decode())
    moe_ffn_bwd.launches += 1
    return dx, dwi, dwg, dwo


#: backward calls (four kernels each) since the count was last set to 0
moe_ffn_bwd.launches = 0


def _dims(xd, wi):
    """(E, C, d, f) of a call."""
    return (*xd.shape, wi.shape[-1])


def _ffn_cost(xd, wi) -> KernelCost:
    return moe_ffn_cost(*_dims(xd, wi), xd.element_size())


def _dtype_of(itemsize: int):
    """The dtype whose peak rate a call of operands of ``itemsize`` bytes
    takes: f32 on the CUDA cores, else bf16 on the tensor cores."""
    return torch.float32 if itemsize == 4 else torch.bfloat16


# The counts that depend on the data (the dispatched rows, the experts that
# hold a token) are the caller's to give; without them (a dry run cannot
# read the dispatch buffer) each cost function takes their upper bound:
# every one of the E x C rows dispatched, every expert holding a token.


def moe_ffn_cost(e: int, c: int, d: int, f: int, itemsize: int, *,
                 rows=None, experts=None) -> KernelCost:
    """One K7 decode-kernel call's least work: xd read and the output
    written once, the three weights of each expert holding a token read
    once; 6 flops a dispatched row a (d, f) pair (gate, up and down)."""
    rows = e * c if rows is None else rows
    experts = e if experts is None else experts
    nbytes = itemsize * (experts * 3 * d * f + 2 * e * c * d)
    return KernelCost(6 * rows * d * f, nbytes, _dtype_of(itemsize))


def moe_ffn_train_cost(e: int, c: int, d: int, f: int, itemsize: int, *,
                       rows=None, experts=None) -> KernelCost:
    """One training-forward call's least work: ``moe_ffn_cost``'s, and the
    A, h and g (E, C, f) it writes for the backward."""
    rows = e * c if rows is None else rows
    experts = e if experts is None else experts
    nbytes = itemsize * (2 * e * c * d + 3 * e * c * f + experts * 3 * d * f)
    return KernelCost(6 * rows * d * f, nbytes, _dtype_of(itemsize))


def moe_ffn_bwd_cost(e: int, c: int, d: int, f: int, itemsize: int, *,
                     saved: bool, rows=None, experts=None) -> KernelCost:
    """One backward call's least work: 12 flops a dispatched row a (d, f)
    pair (dA, dX's two products, dWi, dWg, dWo); xd, dout and dX, with
    ``saved`` (``moe_ffn_bwd_saved``) the training forward's A, h and g
    that it reads, the weights of the experts holding a token read once
    and every expert's three weight gradients written once."""
    rows = e * c if rows is None else rows
    experts = e if experts is None else experts
    nbytes = itemsize * (3 * e * c * d + (3 * e * c * f if saved else 0)
                         + 3 * d * f * (experts + e))
    return KernelCost(12 * rows * d * f, nbytes, _dtype_of(itemsize))
