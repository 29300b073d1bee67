"""Device mesh — port of ``lvislam_tpu.parallel.mesh``.

The JAX mesh is single-controller: one process and an array of devices with
two logical axes,

- ``batch``: independent replay sequences (data parallel);
- ``map``: spatial shards of the global map for the kNN and the GN solve.

The port keeps that design. A ``Mesh`` is a (batch, map) array of
``torch.device`` in one process; a "collective" is a ``.to(device)`` copy
and a ``torch.cat``. A mesh may name one device in several slots, as the
JAX tests' virtual devices all share one CPU, so the sharding arithmetic
runs on a machine with one card too.

``put(x, mesh, placement)`` is the counterpart of ``jax.device_put(x,
NamedSharding(mesh, spec))``: it splits one dimension into equal shards
along the named axis, one a slot of that axis, each on the device of the
slot's first replica (the slot at index 0 of the other axis), and returns a
``Sharded`` of the per-slot tensors. A replicated placement is the tensor
itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve as resolve_device

AXES = ("batch", "map")


class Mesh:
    """A (batch, map) array of devices (``devices``, a numpy object array);
    ``shape["batch"]`` and ``shape["map"]`` read as in JAX."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    def slot_devices(self, axis: str) -> list[torch.device]:
        """The device of each slot along `axis` (its first replica's)."""
        return list(self.devices[:, 0] if axis == "batch" else self.devices[0, :])


class Placement(NamedTuple):
    """Where a value lives on a mesh: dimension `dim` split along mesh axis
    `axis`, or replicated (`axis` None); JAX's ``PartitionSpec``."""

    axis: str | None
    dim: int = 0


class Sharded(NamedTuple):
    """A value split along one mesh axis: `shards[i]` is slot i's part,
    on that slot's device."""

    shards: tuple
    axis: str
    dim: int = 0


def make_mesh(n_devices: int | None = None, map_parallel: int = 1, devices=None) -> Mesh:
    """The (n // map_parallel, map_parallel) mesh of `devices` (default:
    every visible CUDA device; without a GPU that raises). Devices may be
    strings or ``torch.device``, and repeat."""
    if devices is None:
        resolve_device(None)  # raises without a GPU
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    assert n % map_parallel == 0, (n, map_parallel)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // map_parallel, map_parallel))


def batch_sharding(mesh: Mesh) -> Placement:
    return Placement("batch", 0)


def map_sharding(mesh: Mesh) -> Placement:
    return Placement("map", 1)  # JAX's P(None, "map")


def replicated(mesh: Mesh) -> Placement:
    return Placement(None)


def put(x: torch.Tensor, mesh: Mesh, placement: Placement):
    """`x` placed on `mesh`: a ``Sharded`` of equal shards of dimension
    `placement.dim`, one a slot of `placement.axis` on its device, or `x`
    itself when replicated."""
    if placement.axis is None:
        return x
    devs = mesh.slot_devices(placement.axis)
    n = len(devs)
    assert x.shape[placement.dim] % n == 0, (tuple(x.shape), placement, n)
    parts = torch.chunk(x, n, dim=placement.dim)
    return Sharded(tuple(p.to(d) for p, d in zip(parts, devs)), placement.axis, placement.dim)


def gather(x) -> torch.Tensor:
    """A ``Sharded`` value whole on its first slot's device (a plain tensor
    as it is)."""
    if not isinstance(x, Sharded):
        return x
    dev = x.shards[0].device
    return torch.cat([s.to(dev) for s in x.shards], dim=x.dim)


def _is_leaf(x) -> bool:
    return x is None or isinstance(x, (torch.Tensor, Sharded))


def tree_map(fn, tree, *rest):
    """`fn` over the leaves (tensors, ``Sharded`` values) of a tree of
    NamedTuples, tuples, lists and dicts, and the matching leaves of
    `rest`."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    kids = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)


def leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def put_tree(tree, mesh: Mesh, placement: Placement):
    """``put`` of every tensor leaf of `tree`."""
    return tree_map(lambda x: x if x is None else put(x, mesh, placement), tree)
