"""Inputs of the lockstep-GN tests (``test_torch_lockstep.py`` on the CPU,
``test_torch_cuda_batched.py`` on the card), with no JAX import: box worlds
(three planes and an edge, as ``tests/test_torch_scan2map.py``'s) drawn
from a seed, their voxel hashes, and ``scan_to_map_hashed``'s arguments for
a few sequences."""

import numpy as np
import torch

from lvislam_tpu_torch.core import lie
from lvislam_tpu_torch.ops import voxel_hash as vh

# three sequences (world seed, share of the true pose to start at): with
# the kernels' flags and MAX_ITERS, two converge at different iterations and
# the third runs to MAX_ITERS
SEQS = ((0, 0.0), (4, 0.5), (3, 0.0))
MAX_ITERS = 12
FLAG_SETS = {
    "gather_once_k2": dict(use_pallas=True, gather_once=True, use_pallas_gn=True),
    "fused_k2": dict(use_pallas=True, gather_once=False, use_pallas_gn=True),
    "gather_once_coeffs": dict(use_pallas=True, gather_once=True, use_pallas_gn=False),
    "plain": dict(use_pallas=False, gather_once=False, use_pallas_gn=False),
}


def world(seed: int, n: int = 2048):
    """(map_corner, map_surf, corner scan, surf scan, true pose) as numpy
    float32; every seed gives the same sizes."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-8, 8, (n, 2)).astype(np.float32)
    planes = [np.stack([g[:, 0], g[:, 1], np.zeros(n)], -1),
              np.stack([g[:, 0], np.full(n, -8.0), g[:, 1] * 0.3 + 2], -1),
              np.stack([np.full(n, 8.0), g[:, 0], g[:, 1] * 0.3 + 2], -1)]
    edge_t = rng.uniform(-8, 8, n).astype(np.float32)
    map_surf = np.concatenate(planes).astype(np.float32)
    map_corner = np.stack([edge_t, np.full(n, -8.0), np.full(n, 5.0)], -1).astype(np.float32)
    ci = rng.choice(n, 256, replace=False)
    si = rng.choice(len(map_surf), 1024, replace=False)
    x6_true = (rng.uniform(-1, 1, 6) * np.array([0.03, 0.03, 0.04, 0.25, 0.25, 0.1])
               ).astype(np.float32)
    R = lie.x6_rotation(torch.from_numpy(x6_true)).numpy()
    corner_scan = ((map_corner[ci] - x6_true[3:6]) @ R).astype(np.float32)
    surf_scan = ((map_surf[si] - x6_true[3:6]) @ R).astype(np.float32)
    return map_corner, map_surf, corner_scan, surf_scan, x6_true


def hashes(w, dev="cpu"):
    """The corner (B = 32) and surf (B = 16) hashes of world `w`."""
    mc, ms = (torch.as_tensor(a, device=dev) for a in w[:2])
    return (vh.build(mc, torch.ones(len(mc), dtype=torch.bool, device=dev), 1.0, 1 << 12, 32),
            vh.build(ms, torch.ones(len(ms), dtype=torch.bool, device=dev), 1.0, 1 << 13, 16))


def gn_args(seqs=SEQS, dev="cpu"):
    """Per sequence, `scan_to_map_hashed`'s positional arguments."""
    out = []
    for seed, share in seqs:
        w = world(seed)
        hc, hs = hashes(w, dev)
        f = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        out.append((f(w[4] * share), f(w[2]), torch.ones(256, dtype=torch.bool, device=dev),
                    f(w[3]), torch.ones(1024, dtype=torch.bool, device=dev), f(w[0]), f(w[1]),
                    hc, hs))
    return out


def stack_args(args):
    """`scan_to_map_hashed_batched`'s arguments for the sequences `args`."""
    cols = list(zip(*args))
    return [torch.stack(c) for c in cols[:7]] + [vh.stack(cols[7]), vh.stack(cols[8])]
