"""Map-sharded exact kNN — port of ``lvislam_tpu.parallel.sharded_knn``.

The map is split along the point dimension over the mesh's ``map`` axis.
Each shard runs the exact ``ops.scan2map.knn`` against its part on its own
device and offsets its indices to global ones; the per-shard candidates
travel to the query's device (JAX's ``all_gather``), are concatenated in
shard order, and one more selection keeps the k best. The selection is a
stable sort, so a tie goes to the lower position, that is the lower shard
and then the lower local rank, as ``lax.top_k`` does in JAX.
"""

from __future__ import annotations

import torch

from ..ops.scan2map import knn as local_knn
from .mesh import Mesh, Placement, Sharded, put


def merge_topk(cands: list[torch.Tensor], dists: list[torch.Tensor], k: int):
    """The k nearest of per-shard candidate sets: `cands[i]` (Q, k, ...)
    and `dists[i]` (Q, k) of shard i, on one device. Returns (the chosen
    candidates (Q, k, ...), their distances (Q, k)); ties to the lowest
    shard, then the lowest local rank."""
    d = torch.cat(dists, dim=1)
    c = torch.cat(cands, dim=1)
    srt = torch.sort(d, dim=1, stable=True)
    sel = srt.indices[:, :k]
    sel = sel.reshape(sel.shape + (1,) * (c.dim() - 2)).expand(*sel.shape, *c.shape[2:])
    return torch.gather(c, 1, sel), srt.values[:, :k]


def map_shards(x, mesh: Mesh) -> tuple:
    """The ``map`` shards of `x` (a ``Sharded`` value, or a tensor that is
    split here)."""
    if not isinstance(x, Sharded):
        x = put(x, mesh, Placement("map"))
    assert x.axis == "map" and x.dim == 0, (x.axis, x.dim)
    return x.shards


def sharded_knn(mesh: Mesh, k: int = 5, chunk: int = 4096):
    """Returns fn(query (Q, 3), query_valid, map_pts (M, 3), map_valid) ->
    (idx (Q, k) GLOBAL indices, sqdist (Q, k)) on the query's device, with
    `map_pts` and `map_valid` sharded over the ``map`` axis."""

    def fn(query, query_valid, map_pts, map_valid):
        dev = query.device
        idx, dist, off = [], [], 0
        for m, mv in zip(map_shards(map_pts, mesh), map_shards(map_valid, mesh)):
            i, d = local_knn(query.to(m.device), query_valid.to(m.device), m, mv, k=k,
                             chunk=min(chunk, m.shape[0]))
            idx.append((i + off).to(dev))
            dist.append(d.to(dev))
            off += m.shape[0]
        return merge_topk(idx, dist, k)

    return fn
