"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

Each kernel family has an ``ops`` module holding the wrapper, the kernel's
plain PyTorch version and a launch counter.  A wrapper takes the plain
version only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises.
"""
