"""Map-sharded scan-to-map GN — port of
``lvislam_tpu.parallel.sharded_scan2map`` (`scan2MapOptimization`,
`mapOptimization.cpp:1315-1343`).

The local map's corner and surf sets are split along the point dimension
over the mesh's ``map`` axis; the scan and the 6-DoF state stay on the
scan's device. Each GN iteration:

1. every shard runs the exact 5-NN (``ops.scan2map.knn``) against its part,
   on its own device;
2. the shards ship COORDINATES (not indices) with their distances to the
   scan's device, and one stable selection merges them into the exact
   global 5-NN neighbourhoods (``sharded_knn.merge_topk``);
3. the coefficients and the GN step (``corner_coeffs_nbrs``,
   ``surf_coeffs_nbrs``, ``gn_update``) run on the merged neighbourhoods.

Shipping coordinates keeps the merge local: the global best neighbours of a
query may lie on different shards, and gathering rows after an index merge
would need a second exchange. As in ``ops.scan2map.scan_to_map``, the loop
stops on one host read of the convergence flag an iteration.
"""

from __future__ import annotations

import torch

from ..core import hostsync, lie
from ..ops.scan2map import (
    Coeffs,
    GNState,
    corner_coeffs_nbrs,
    gn_update,
    knn as local_knn,
    surf_coeffs_nbrs,
)
from .mesh import Mesh
from .sharded_knn import map_shards, merge_topk


def _shard_nn_coords(q, m_pts, m_valid, k):
    """Exact global k-NN neighbourhoods of the queries `q` against the
    shards `m_pts` / `m_valid` (sequences of per-shard tensors), as merged
    COORDINATES (Q, k, 3) and a presence mask (Q, k), on q's device."""
    dev = q.device
    nbs, ds = [], []
    for m, mv in zip(m_pts, m_valid):
        qm = q.to(m.device)
        idx, d = local_knn(qm, torch.ones(q.shape[0], dtype=torch.bool, device=m.device),
                           m, mv, k=k)
        nbs.append(m[torch.clamp(idx, min=0)].to(dev))  # (Q, k, 3) shard rows
        ds.append(d.to(dev))  # invalid refs sit at _BIG: key and presence
    nb, d = merge_topk(nbs, ds, k)
    return nb, d < 1e9  # below the invalid-reference sentinel


def sharded_scan_to_map(mesh: Mesh, max_iters: int = 20, eigen_thresh: float = 100.0):
    """The map-sharded GN solver over `mesh`. Returns fn(x6_init,
    corner_pts, corner_valid, surf_pts, surf_valid, map_corner,
    map_corner_valid, map_surf, map_surf_valid) -> GNState, the four map
    arrays sharded over ``map`` (``Sharded`` values, or tensors split here),
    everything else on the scan's device. Semantics of
    ``ops.scan2map.scan_to_map``."""

    def fn(x6_init, corner_pts, corner_valid, surf_pts, surf_valid,
           map_corner, map_corner_valid, map_surf, map_surf_valid):
        mc, mcv = map_shards(map_corner, mesh), map_shards(map_corner_valid, mesh)
        ms, msv = map_shards(map_surf, mesh), map_shards(map_surf_valid, mesh)
        dev, dt = x6_init.device, x6_init.dtype
        st = GNState(
            x6=x6_init, it=torch.zeros((), dtype=torch.int32, device=dev),
            converged=torch.zeros((), dtype=torch.bool, device=dev),
            degenerate=torch.zeros((), dtype=torch.bool, device=dev),
            proj=torch.eye(6, dtype=dt, device=dev),
            num_residuals=torch.zeros((), dtype=torch.int32, device=dev),
        )
        pts = torch.cat([corner_pts, surf_pts])
        for it in range(max_iters):
            Rm = lie.x6_rotation(st.x6)
            t = st.x6[3:6]
            cw = corner_pts @ Rm.T + t
            sw = surf_pts @ Rm.T + t
            cc = corner_coeffs_nbrs(cw, corner_valid, *_shard_nn_coords(cw, mc, mcv, 5))
            sc = surf_coeffs_nbrs(sw, surf_pts, surf_valid, *_shard_nn_coords(sw, ms, msv, 5))
            coeffs = Coeffs(*(torch.cat([a, b]) for a, b in zip(cc, sc)))
            new_x, conv, proj, degen, n_res = gn_update(
                st.x6, pts, coeffs, it == 0, st.proj, st.degenerate,
                eigen_thresh=eigen_thresh)
            st = GNState(x6=new_x, it=st.it + 1, converged=conv, degenerate=degen,
                         proj=proj, num_residuals=n_res.to(torch.int32))
            if hostsync.host_bool(conv):
                break
        return st

    return fn
