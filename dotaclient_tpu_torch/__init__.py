"""PyTorch/CUDA port of the dotaclient policy and learner math.

Mirrors `dotaclient_tpu`'s module layout (ops/lstm.py ↔ ops/lstm.py, …)
but imports nothing from it: every constant and dataclass the port needs
is its own copy. Entry points run on the GPU unless the caller passes
`device="cpu"` explicitly; they never fall back to the CPU on their own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device,
    and raises when there is none (no silent CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
