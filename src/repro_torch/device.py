"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a card
    raises instead of running on the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        if dev.index is None:       # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
