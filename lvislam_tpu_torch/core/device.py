"""The device the port's entry points run on when the caller names none."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (``cuda``).
    Without a CUDA device, None or a ``cuda`` device raises: the port runs
    on the CPU only when asked to (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def common(tensors, name: str) -> torch.device:
    """The one device that every tensor of ``tensors`` lies on. A kernel
    wrapper picks its path by it, so inputs on more than one device raise
    ``ValueError``: the plain version must never run on a CUDA tensor."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on different devices "
                         f"({', '.join(sorted(map(str, devs)))})")
    return devs.pop()
