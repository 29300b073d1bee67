"""Batched multi-sequence LIO — port of ``lvislam_tpu.parallel.batch_replay``.

N independent sequences (multi-robot logs, parameter sweeps, Monte-Carlo
robustness runs) stepped in lockstep. The batched state keeps JAX's layout:
every leaf of ``LioMapState`` carries a leading B axis. With a mesh, every
leaf is a ``Sharded`` value over the ``batch`` axis, each slot's sequences
on that slot's device.

JAX ``vmap``s ``mapping.map_step``; under that ``vmap`` the GN's
``while_loop`` steps all sequences in lockstep and kernels K1 and K2 run
once for all of them. The batched step here splits ``map_step`` where the
port branches on host reads:

1. ``mapping.map_prologue`` a sequence (the initial guess, the voxel
   downsamples, the gate), on its slot's device;
2. one lockstep GN (``scan2map.scan_to_map_hashed_batched``) for each
   device's sequences whose gate passed: an iteration launches K1 once on a
   refresh and K2 once for all of them, and reads their S convergence flags
   once;
3. ``mapping.map_epilogue`` a sequence (the keyframe, rebuild, GPS and loop
   branches), with the zero GN outputs of ``map_step`` where the gate
   failed.

A sequence's result is exactly its unbatched step's (JAX's ``vmap`` of a
``while_loop`` or ``cond`` gives it up to rounding).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..core.device import resolve as resolve_device
from ..models.lio import mapping
from ..ops import scan2map
from ..ops import voxel_hash as vh
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


def _positions(tree) -> list:
    """(shard, row) of each sequence of a batched tree, in ``_unstack``'s
    order (shard None for plain leading-B leaves)."""
    first = leaves(tree)[0]
    if not isinstance(first, Sharded):
        return [(None, b) for b in range(first.shape[0])]
    return [(j, i) for j, part in enumerate(first.shards) for i in range(part.shape[0])]


def _rows(leaf, pos) -> torch.Tensor:
    """The sequences at `pos` of a batched leaf as one tensor: a slice of
    the leaf (or of its shard) where they are consecutive rows of one, so
    no copy; else a stack."""
    part = lambda j: leaf if j is None else leaf.shards[j]
    (j0, i0), n = pos[0], len(pos)
    if pos == [(j0, i0 + k) for k in range(n)]:
        return part(j0)[i0: i0 + n]
    return torch.stack([part(j)[i] for j, i in pos])


def _lockstep_gn(state, pos, pros, x6, caps: mapping.LioCaps, params: mapping.LioParams):
    """``mapping.map_gn`` in lockstep for the sequences at `pos` of the
    batched `state` (one device), from their prologues `pros` and initial
    guesses `x6`: the per-sequence GNStates (views of the batched one). The
    maps and hashes are the batched state's rows, which the prologue leaves
    as they are."""
    stack = lambda xs: torch.stack(list(xs))
    rows = lambda x: _rows(x, pos)
    with record_function("lio.scan_to_map"):
        st = scan2map.scan_to_map_hashed_batched(
            stack(x6), stack(p.c_xyz for p in pros), stack(p.c_val for p in pros),
            stack(p.s_xyz for p in pros), stack(p.s_val for p in pros),
            rows(state.map_corner), rows(state.map_surf),
            vh.VoxelHash(*map(rows, state.corner_hash)),
            vh.VoxelHash(*map(rows, state.surf_hash)), **mapping.gn_options(caps, params))
    return [scan2map.GNState(*(x[i] for x in st)) for i in range(len(pos))]


def make_batched_step(caps: mapping.LioCaps, params: mapping.LioParams,
                      mesh: Mesh | None = None):
    """Returns fn(batched_state, batched_scan, batched_feats) ->
    (batched_state, batched_outputs). With `mesh`, a state given whole is
    first sharded over ``batch`` (JAX constrains every input so); the
    outputs follow the state's placement."""

    def step(state, scan, feats):
        if mesh is not None and not isinstance(leaves(state)[0], Sharded):
            state = put_tree(state, mesh, batch_sharding(mesh))
        seqs = []
        for s, sc, ft in zip(_unstack(state), _unstack(scan), _unstack(feats)):
            dev = s.x6.device
            sc = {k: v.to(dev) for k, v in sc.items()}
            ft = tree_map(lambda x: x.to(dev), ft)
            s, pro = mapping.map_prologue(s, sc, ft, caps, params)
            seqs.append((s, sc, ft, pro))
        groups: dict = {}  # device -> the sequences whose gate passed
        for i, (s, _, _, pro) in enumerate(seqs):
            if pro.run_gn:
                groups.setdefault(s.x6.device, []).append(i)
        gn, pos = [None] * len(seqs), _positions(state)
        for idx in groups.values():
            sts = _lockstep_gn(state, [pos[i] for i in idx], [seqs[i][3] for i in idx],
                               [seqs[i][0].x6 for i in idx], caps, params)
            for i, st in zip(idx, sts):
                gn[i] = st
        new, outs = [], []
        for (s, sc, ft, pro), st in zip(seqs, gn):
            s2, out = mapping.map_epilogue(s, pro, st, sc, ft, caps, params)
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
