"""Batched multi-sequence LIO — port of ``lvislam_tpu.parallel.batch_replay``.

N independent sequences (multi-robot logs, parameter sweeps, Monte-Carlo
robustness runs) stepped in lockstep. The batched state keeps JAX's layout:
every leaf of ``LioMapState`` carries a leading B axis. With a mesh, every
leaf is a ``Sharded`` value over the ``batch`` axis, each slot's sequences
on that slot's device.

JAX ``vmap``s ``mapping.map_step``. The port's ``map_step`` branches on host
reads (the GN solve, the keyframe gate, the GPS factor, the map rebuild) and
calls kernels K1 and K2, which have no batching rule; so the batched step
runs one ``map_step`` a sequence, on its slot's device, each with its own
host decisions, and stacks the results back. A sequence's result is exactly
its unbatched step's (JAX's ``vmap`` of a ``while_loop`` or ``cond`` gives it
up to rounding).
"""

from __future__ import annotations

import torch

from ..core.device import resolve as resolve_device
from ..models.lio import mapping
from .mesh import Mesh, Sharded, batch_sharding, leaves, put_tree, tree_map


def _unstack(tree) -> list:
    """The per-sequence trees of a batched tree (state, scan dict or
    features: plain leading-B leaves, or ``Sharded`` over ``batch``), each
    sequence's leaves on its device."""
    first = leaves(tree)[0]
    if not isinstance(first, Sharded):
        return [tree_map(lambda x, b=b: x[b], tree) for b in range(first.shape[0])]
    out = []
    for j, part in enumerate(first.shards):
        out += [tree_map(lambda x, j=j, i=i: x.shards[j][i], tree)
                for i in range(part.shape[0])]
    return out


def _stack(trees: list, like):
    """The inverse of ``_unstack``: sequences stacked back into `like`'s
    placement."""
    first = leaves(like)[0]
    if not isinstance(first, Sharded):
        return tree_map(lambda *xs: torch.stack(xs), *trees)
    out, b = [], 0
    for part in first.shards:
        n = part.shape[0]
        out.append(tree_map(lambda *xs: torch.stack(xs), *trees[b: b + n]))
        b += n
    return tree_map(lambda *xs: Sharded(tuple(xs), "batch"), *out)


def batched_lio_init(caps: mapping.LioCaps, batch: int, mesh: Mesh | None = None,
                     device=None):
    """B copies of the empty map state with a leading B axis: on `device`
    (the card unless named) or, with `mesh`, sharded over its ``batch``
    axis."""
    if mesh is not None:
        state = mapping.lio_init(caps, mesh.slot_devices("batch")[0])
        bstate = tree_map(lambda x: x.expand((batch,) + x.shape).clone(), state)
        return put_tree(bstate, mesh, batch_sharding(mesh))
    state = mapping.lio_init(caps, resolve_device(device))
    return tree_map(lambda x: x.expand((batch,) + x.shape).clone(), state)


def make_batched_step(caps: mapping.LioCaps, params: mapping.LioParams,
                      mesh: Mesh | None = None):
    """Returns fn(batched_state, batched_scan, batched_feats) ->
    (batched_state, batched_outputs). With `mesh`, a state given whole is
    first sharded over ``batch`` (JAX constrains every input so); the
    outputs follow the state's placement."""

    def step(state, scan, feats):
        if mesh is not None and not isinstance(leaves(state)[0], Sharded):
            state = put_tree(state, mesh, batch_sharding(mesh))
        states = _unstack(state)
        new, outs = [], []
        for s, sc, ft in zip(states, _unstack(scan), _unstack(feats)):
            dev = s.x6.device
            sc = {k: v.to(dev) for k, v in sc.items()}
            ft = tree_map(lambda x: x.to(dev), ft)
            s2, out = mapping.map_step(s, sc, ft, caps, params)
            new.append(s2)
            outs.append(out)
        return _stack(new, state), _stack(outs, state)

    return step


def make_batched_loop_step(caps: mapping.LioCaps, params: mapping.LioParams):
    """Returns fn(batched_state) -> (batched_state, batched LoopResult):
    ``mapping.loop_closure_step`` a sequence."""

    def step(state):
        new, res = [], []
        for s in _unstack(state):
            s2, r = mapping.loop_closure_step(s, caps, params)
            new.append(s2)
            res.append(r)
        return _stack(new, state), _stack(res, state)

    return step
