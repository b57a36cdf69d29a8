"""The port's one device rule: CUDA unless the caller asks for the CPU.

Every entry point that places tensors resolves its device here.  There is
no silent fallback: with no CUDA device and no explicit ``device="cpu"``,
:func:`resolve_device` raises.  Callers ask for the CPU with ``device=`` on
the batcheval facade or with ``batcheval.eval_options(device="cpu")``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "upload"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (None = ``"cuda"``) as a ``torch.device``; raises when it
    names CUDA and no CUDA device is present, or names another kind."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or run "
                "under batcheval.eval_options(device='cpu')) to run on the "
                "CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the copy: through a
    pinned staging buffer, asynchronously, on CUDA (the caching host
    allocator keeps the buffer alive until the copy is done)."""
    t = torch.from_numpy(np.require(x, requirements=("C", "W")))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
