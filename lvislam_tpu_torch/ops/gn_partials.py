"""Kernel K2: fused LOAM coefficients + Gauss-Newton row partials.

Replaces the TPU kernel ``lvislam_tpu/ops/pallas_gn.py:369
gn_partials_packed`` (bodies ``_corner_kernel`` / ``_surf_kernel``). For one
feature class it returns the same (H (6,6), g (6,), n_res) that
``scan2map.gn_update`` assembles from ``corner_coeffs_nbrs`` /
``surf_coeffs_nbrs`` rows.

CUDA design (``csrc/gn_partials.cu``): one thread per point follows the
plain path op for op — the world transform, the 5-neighbour 1 m² gate, the
mean and scatter, the closed-form 3×3 eigensystem with a true ``acosf`` (the
TPU kernel's polynomial acos cost +12% LIO ATE), the point-to-line or
Sherman-Morrison plane coefficients, the robust weight, the J row — then
writes its 28 partials (21 JᵀJ, 6 Jᵀb, 1 count) into shared memory, where a
fixed-order tree reduces them to one row per block. ``torch.sum`` over the
block rows gives H, g and n_res. No float atomics: two runs give the same
bits. Its multiply-adds are contracted into FMAs (nvcc's default), as XLA's
CPU backend contracts the reference's: on the bench replay that moved the
mean ATE over 20 rounding-perturbed runs from 0.0385 m to 0.0377 m (see
PERF.md). What bounds it on the card: launch latency — 512 or 2048 points
of ~1k flops each, 4 or 16 blocks.

Packed layouts (the kernel reads them coalesced, one column per thread):

- ``pts`` (8, N): rows 0-2 lidar xyz, row 3 valid, rows 4-7 zero — loop
  invariant, packed once per scan;
- ``nbr`` (24, N): rows 3k+c neighbour k's coordinate c, rows 15-19 the
  present mask, rows 20-23 zero — packed on correspondence refresh;
- ``par`` (39,): R row-major (9), t (3), then Ja, Jb, Jc row-major (27),
  the per-iteration pose (see ``scan2map._euler_jac_mats``).
"""

from __future__ import annotations

import torch

from . import _kernels

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke reads it)
_KINDS = {"corner": 0, "surf": 1}
# H[a, b] = part[_SYM[a, b]]: position of (min(a,b), max(a,b)) in the
# row-major upper triangle the kernel writes
_SYM = torch.tensor([[(min(a, b) * (11 - min(a, b))) // 2 + max(a, b)
                      for b in range(6)] for a in range(6)])


def pack_pts(pts_lidar: torch.Tensor, pts_valid: torch.Tensor) -> torch.Tensor:
    N = pts_lidar.shape[0]
    return torch.cat([
        pts_lidar.T.to(torch.float32),
        pts_valid.to(torch.float32)[None, :],
        torch.zeros((4, N), dtype=torch.float32, device=pts_lidar.device),
    ], dim=0).contiguous()


def pack_nbrs(nbrs: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    N = nbrs.shape[0]
    return torch.cat([
        nbrs.reshape(N, 15).T.to(torch.float32),
        has.to(torch.float32).T,
        torch.zeros((4, N), dtype=torch.float32, device=nbrs.device),
    ], dim=0).contiguous()


def pack_pose(Rm: torch.Tensor, t: torch.Tensor, jacs: torch.Tensor) -> torch.Tensor:
    return torch.cat([Rm.reshape(9), t.reshape(3), jacs.reshape(27)]
                     ).to(torch.float32).contiguous()


def _assemble(part: torch.Tensor):
    return (part[_SYM.to(part.device)], part[21:27], part[27].to(torch.int32))


def gn_partials_plain(pts: torch.Tensor, nbr: torch.Tensor, par: torch.Tensor,
                      kind: str):
    """Plain PyTorch version: the scan2map coefficient path + the
    ``gn_update`` row assembly on the unpacked blocks."""
    from . import scan2map

    N = pts.shape[1]
    q = pts[0:3].T
    valid = pts[3] > 0.5
    nbrs = nbr[0:15].T.reshape(N, 5, 3)
    has = nbr[15:20].T > 0.5
    R = par[0:9].reshape(3, 3)
    t = par[9:12]
    jacs = par[12:39].reshape(3, 3, 3)
    pw = scan2map.apply_pose(R, t, q)
    if kind == "corner":
        co = scan2map.corner_coeffs_nbrs(pw, valid, nbrs, has)
    else:
        co = scan2map.surf_coeffs_nbrs(pw, q, valid, nbrs, has)
    J, b = scan2map.gn_rows(jacs, q, co)
    return J.T @ J, J.T @ b, torch.sum(co.valid, dtype=torch.int32)


def _launch(pts, nbr, par, kind: str):
    global LAUNCHES
    N = pts.shape[1]
    if pts.shape != (8, N) or nbr.shape != (24, N) or par.shape != (39,):
        raise ValueError(f"gn_partials: bad shapes {tuple(pts.shape)} "
                         f"{tuple(nbr.shape)} {tuple(par.shape)}")
    for t in (pts, nbr, par):
        if t.dtype != torch.float32:
            raise TypeError("gn_partials: expects float32 blocks")
        if t.device != pts.device:
            raise ValueError("gn_partials: inputs on different devices")
    pts, nbr, par = pts.contiguous(), nbr.contiguous(), par.contiguous()
    blocks = (N + 127) // 128
    out = torch.empty((max(blocks, 1), 28), dtype=torch.float32, device=pts.device)
    if N == 0:
        out.zero_()
    else:
        lib = _kernels.library()
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.lvt_gn_partials(pts.data_ptr(), nbr.data_ptr(), par.data_ptr(),
                                  out.data_ptr(), N, _KINDS[kind], stream)
        _kernels.check(err, "lvt_gn_partials")
        LAUNCHES += 1
    return _assemble(torch.sum(out, dim=0))


def gn_partials(pts: torch.Tensor, nbr: torch.Tensor, par: torch.Tensor,
                kind: str):
    """(H (6,6), g (6,), n_res () int32) for one feature class ("corner" or
    "surf") from packed blocks. A CPU tensor takes the plain version; a CUDA
    tensor launches kernel K2."""
    if kind not in _KINDS:
        raise ValueError(f"gn_partials: unknown kind {kind!r}")
    if pts.device.type == "cpu":
        return gn_partials_plain(pts, nbr, par, kind)
    if pts.device.type != "cuda":
        raise ValueError(f"gn_partials: unsupported device {pts.device}")
    return _launch(pts, nbr, par, kind)
