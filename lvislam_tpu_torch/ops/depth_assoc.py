"""Lidar depth association for visual features — port of
``lvislam_tpu.ops.depth_assoc`` (the reference's ``DepthRegister::get_depth``,
`feature_tracker.h:116-331`):

1. the depth cloud (camera-body frame: x fwd, y left, z up) is scattered
   into a num_bins x num_bins polar range image over the front hemisphere,
   keeping the nearest point per bin (two scatter-mins: exact, the lowest
   index on range ties, and order-free, so deterministic on the card);
2. features lift to the unit sphere in the same frame;
3. exact 3-NN on the sphere in a +-window-bin neighbourhood;
4. the feature ray meets the plane of the 3 neighbours; rejected if their
   depths spread over 2 m or s <= 0.5, clamped into their depth range;
5. only depths > 3 m are reported; -1 = no depth.
"""

from __future__ import annotations

import math

import torch

from ..core.lie import cross, norm3

_FLT_MAX = 3.4e38


def feature_depths(
    features_norm: torch.Tensor,  # (F, 2) undistorted normalized-plane (x, y)
    features_valid: torch.Tensor,  # (F,)
    cloud_xyz: torch.Tensor,  # (P, 3) depth cloud in camera-BODY frame (x fwd)
    cloud_valid: torch.Tensor,  # (P,)
    num_bins: int = 360,
    window: int = 6,  # +-bins of exact NN search (covers the kd gate)
) -> torch.Tensor:
    """Returns (F,) depths in the z-forward camera convention; -1 = none."""
    dev = cloud_xyz.device
    P = cloud_xyz.shape[0]
    F = features_norm.shape[0]
    bin_res = 180.0 / num_bins
    rad2deg = 180.0 / math.pi
    nbin2 = num_bins * num_bins

    # --- range-image scatter (nearest point per polar bin) ---
    x, y, z = cloud_xyz[:, 0], cloud_xyz[:, 1], cloud_xyz[:, 2]
    xs = torch.clamp(x, min=1e-9)
    ok = cloud_valid & (x > 0) & (torch.abs(y / xs) <= 10) & (torch.abs(z / xs) <= 10)
    row_angle = torch.atan2(z, torch.sqrt(x * x + y * y)) * rad2deg + 90.0
    col_angle = torch.atan2(x, y) * rad2deg
    row = torch.round(row_angle / bin_res).to(torch.int64)
    col = torch.round(col_angle / bin_res).to(torch.int64)
    ok &= (row >= 0) & (row < num_bins) & (col >= 0) & (col < num_bins)
    rng = norm3(cloud_xyz)
    flat = torch.where(ok, row * num_bins + col, torch.full_like(row, nbin2))

    rngw = torch.where(ok, rng, torch.full_like(rng, _FLT_MAX))
    binmin = torch.full((nbin2 + 1,), _FLT_MAX, dtype=rng.dtype, device=dev)
    binmin = binmin.scatter_reduce(0, flat, rngw, "amin")
    is_min = ok & (rngw <= binmin[flat])
    ar = torch.arange(P, dtype=torch.int64, device=dev)
    idxw = torch.where(is_min, ar, torch.full_like(ar, P))
    win = torch.full((nbin2 + 1,), P, dtype=torch.int64, device=dev)
    win = win.scatter_reduce(0, flat, idxw, "amin")[:-1]
    bin_occupied = win < P
    widx = torch.where(bin_occupied, win, torch.zeros_like(win))
    bin_xyz = torch.where(bin_occupied[:, None], cloud_xyz[widx], 0.0)
    bin_rng = torch.where(bin_occupied, rng[widx], torch.full_like(rng[widx], _FLT_MAX))
    bin_unit = bin_xyz / torch.clamp(bin_rng, min=1e-9)[:, None]
    n_pts = torch.sum(bin_occupied)

    # --- features to the unit sphere in the body frame: (1, -x, -y)/norm ---
    v = torch.stack([torch.ones_like(features_norm[:, 0]), -features_norm[:, 0],
                     -features_norm[:, 1]], dim=-1)
    v = v / norm3(v, keepdim=True)
    f_row_angle = torch.atan2(v[:, 2], torch.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)) * rad2deg + 90.0
    f_col_angle = torch.atan2(v[:, 0], v[:, 1]) * rad2deg
    f_row = torch.round(f_row_angle / bin_res).to(torch.int64)
    f_col = torch.round(f_col_angle / bin_res).to(torch.int64)

    # --- windowed exact 3-NN on the sphere ---
    W = 2 * window + 1
    dr = torch.arange(-window, window + 1, device=dev)
    rr = torch.clamp(f_row[:, None, None] + dr[None, :, None], 0, num_bins - 1)
    cc = torch.clamp(f_col[:, None, None] + dr[None, None, :], 0, num_bins - 1)
    cand = (rr * num_bins + cc).reshape(F, W * W)
    d2 = torch.sum((bin_unit[cand] - v[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(bin_occupied[cand], d2, torch.full_like(d2, _FLT_MAX))
    srt = torch.sort(d2, dim=1, stable=True)  # lax.top_k(-d2): ties to lowest
    nd2 = srt.values[:, :3]
    nn = torch.gather(cand, 1, srt.indices[:, :3])  # (F, 3) bin ids

    # the kd-tree gate, in f32 as JAX forms it
    thr = float((torch.sin(torch.tensor(bin_res * math.pi / 180.0, dtype=torch.float32)) * 5.0) ** 2)
    have3 = (nd2[:, 2] < thr) & (n_pts >= 10) & features_valid

    r123 = bin_rng[nn]  # (F, 3)
    ABC = bin_unit[nn] * r123[..., None]  # (F, 3, 3) cartesian neighbours
    A, B, C = ABC[:, 0], ABC[:, 1], ABC[:, 2]
    N = cross(A - B, B - C)
    denom = torch.sum(N * v, dim=-1)
    s = torch.sum(N * A, dim=-1) / torch.where(torch.abs(denom) > 1e-9, denom,
                                               torch.full_like(denom, float("inf")))
    min_d = torch.amin(r123, dim=1)
    max_d = torch.amax(r123, dim=1)
    good = have3 & (max_d - min_d <= 2.0) & (s > 0.5)
    s = torch.clamp(s, min_d, max_d)

    # depth for the z-forward camera: body x component of the scaled ray
    depth = v[:, 0] * s
    return torch.where(good & (depth > 3.0), depth, torch.full_like(depth, -1.0))
