"""PyTorch/CUDA port of the Harvest serving system.

The package mirrors ``repro``'s layout (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``launch``) so each module's counterpart is found by
its path.  It imports ``torch`` and numpy only.  Entry points take an
explicit ``device`` that defaults to ``"cuda"``; the CPU runs only when a
caller asks for it, and then the kernels' plain PyTorch versions compute.
"""
