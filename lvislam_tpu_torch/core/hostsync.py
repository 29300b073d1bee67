"""Host-side branch decisions.

The JAX step keeps every branch on the device (``lax.cond``,
``lax.while_loop``). The port branches in Python instead, which costs one
device-to-host read per decision. Every such read goes through
``host_bool`` / ``host_int`` so a run can count them (``COUNT``), as does
every readback of a result through ``host_numpy``.
"""

from __future__ import annotations

import torch

COUNT = 0


def host_bool(x: torch.Tensor) -> bool:
    global COUNT
    COUNT += 1
    return bool(x.item())


def host_int(x: torch.Tensor) -> int:
    global COUNT
    COUNT += 1
    return int(x.item())


def host_numpy(x: torch.Tensor):
    """One readback of a whole tensor (a summary vector, a table)."""
    global COUNT
    COUNT += 1
    return x.detach().cpu().numpy()


def reset() -> None:
    global COUNT
    COUNT = 0
