"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

Each kernel family has an ``ops`` module holding the wrapper, the kernel's
plain PyTorch version and a launch counter.  A wrapper takes the plain
version only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises.
"""
import torch


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would cut a gradient: grad
    mode on and an operand that requires grad.  Wrappers call it on the
    CUDA path only; their plain versions on the CPU stay differentiable."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward yet; call it "
                           f"under torch.no_grad() or on tensors that do not "
                           f"require grad")
