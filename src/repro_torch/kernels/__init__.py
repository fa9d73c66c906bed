"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

Each kernel family has an ``ops`` module holding the wrapper, the kernel's
plain PyTorch version, a launch counter and the kernel's cost function.
A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises; on a ``meta`` tensor (a dry run,
``repro_torch.launch.dryrun``) it returns outputs of the kernel's shapes
and dtypes and computes nothing.

A cost function gives the work a call must do at the least: the
operations its function needs and the bytes it must move (each input
read once, each output written once).  ``chip_smoke.py`` turns it into a
kernel's bound, and a wrapper reports it through :func:`kernel_call` to
any counter listening (``launch.op_analysis.OpCounter``).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


class KernelCost(NamedTuple):
    """One call's least work: ``flops`` its function needs, ``nbytes`` it
    must move, and the ``dtype`` it computes in, which picks the card's
    peak rate (bf16 on the tensor cores, f32 on the CUDA cores)."""
    flops: float
    nbytes: float
    dtype: torch.dtype


@contextlib.contextmanager
def kernel_call(name: str, cost: KernelCost):
    """Around a wrapper's body: tells every counter on the dispatch-mode
    stack that kernel ``name`` (its launch counter's name) ran once with
    ``cost``, and keeps the aten ops inside (a plain version, the outputs'
    allocation) out of their operation counts.  Nothing where no counter
    listens."""
    counters = [m for m in _get_current_dispatch_mode_stack()
                if hasattr(m, "kernel_launch")]
    for c in counters:
        c.kernel_launch(name, cost)
    with contextlib.ExitStack() as stack:
        for c in counters:
            stack.enter_context(c.inside_kernel())
        yield


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would cut a gradient: grad
    mode on and an operand that requires grad.  Wrappers call it on the
    CUDA path only; their plain versions on the CPU stay differentiable."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward yet; call it "
                           f"under torch.no_grad() or on tensors that do not "
                           f"require grad")
