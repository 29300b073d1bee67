"""Point-cloud ops — port of ``lvislam_tpu.ops.pointcloud``: Livox ring
columns and spherical (azimuth) columns, the range-image projection,
rotational deskew, ring compaction and its gather, the fused projection +
compaction, PCL-VoxelGrid downsampling (sort path and dense path), the ego
filter and the rigid cloud transform.

Determinism: every sort is stable (``jnp.argsort``/``jnp.lexsort`` are), the
voxel centroid sums are fixed-order segment sums (``ops.segment``), and the
scatters write unique indices or integers only.
"""

from __future__ import annotations

import math

import torch

from ..core import lie
from .segment import segment_sum, set_rows

_KEY_SENTINEL = 2**31 - 1


def livox_columns(ring: torch.Tensor, valid: torch.Tensor, n_scan: int):
    """Livox column index = per-ring arrival counter: the i-th valid point
    on ring r gets column (number of prior valid points on ring r)."""
    r = torch.where(valid, ring, torch.full_like(ring, n_scan))
    one_hot = (r[None, :] == torch.arange(n_scan, device=ring.device)[:, None]
               ).to(torch.int32)  # (n_scan, P)
    counts = torch.cumsum(one_hot, dim=-1, dtype=torch.int32) - one_hot
    sel = torch.clamp(ring, 0, n_scan - 1).long()
    return torch.gather(counts, 0, sel[None, :])[0]


def spherical_columns(xyz: torch.Tensor, horizon_scan: int) -> torch.Tensor:
    """Velodyne/Ouster column from azimuth (`imageProjection.cpp:597-603`);
    round half to even, as ``jnp.round``."""
    horizon_angle = torch.atan2(xyz[:, 0], xyz[:, 1]) * (180.0 / math.pi)
    ang_res = 360.0 / horizon_scan
    col = -torch.round((horizon_angle - 90.0) / ang_res).to(torch.int32) + horizon_scan // 2
    return torch.where(col >= horizon_scan, col - horizon_scan, col)


def project_to_range_image(
    xyz: torch.Tensor,  # (P, 3)
    intensity: torch.Tensor,  # (P,)
    ring: torch.Tensor,  # (P,) int32
    valid: torch.Tensor,  # (P,) bool
    n_scan: int,
    horizon_scan: int,
    min_range: float,
    max_range: float,
    columns: torch.Tensor | None = None,
    downsample_rate: int = 1,
):
    """Range-image projection with first-point-wins dedup
    (`imageProjection.cpp:570-622`). Returns (range_img (N,H), xyz_img
    (N,H,3), intensity_img (N,H), valid_img (N,H), time_idx_img (N,H): the
    winning point's index, -1 where empty). Empty cells have range inf."""
    P = xyz.shape[0]
    dev = xyz.device
    rng = lie.norm3(xyz)
    ok = valid & (rng >= min_range) & (rng <= max_range)
    ok &= (ring >= 0) & (ring < n_scan)
    if downsample_rate > 1:
        ok &= (ring % downsample_rate) == 0
    if columns is None:
        columns = livox_columns(ring, ok, n_scan)
    ok &= (columns >= 0) & (columns < horizon_scan)
    trash = n_scan * horizon_scan
    flat = torch.where(ok, ring * horizon_scan + columns, torch.full_like(ring, trash)).long()
    # first wins: scatter-min of the point index a cell (integers: order-free)
    winner = torch.full((trash + 1,), P, dtype=torch.int32, device=dev).scatter_reduce(
        0, flat, torch.arange(P, dtype=torch.int32, device=dev), reduce="amin")[:-1]
    cell_valid = winner < P
    widx = torch.where(cell_valid, winner, torch.zeros_like(winner)).long()
    range_img = torch.where(cell_valid, rng[widx], torch.full_like(rng[widx], float("inf")))
    xyz_img = torch.where(cell_valid[:, None], xyz[widx], torch.zeros_like(xyz[widx]))
    inten_img = torch.where(cell_valid, intensity[widx], torch.zeros_like(intensity[widx]))
    time_idx = torch.where(cell_valid, widx, torch.full_like(widx, -1)).to(torch.int32)
    return (range_img.reshape(n_scan, horizon_scan),
            xyz_img.reshape(n_scan, horizon_scan, 3),
            inten_img.reshape(n_scan, horizon_scan),
            cell_valid.reshape(n_scan, horizon_scan),
            time_idx.reshape(n_scan, horizon_scan))


def deskew_points(
    xyz: torch.Tensor,  # (P, 3)
    rel_time: torch.Tensor,  # (P,) seconds from scan start
    imu_time: torch.Tensor,  # (M,) sample times relative to scan start
    imu_quat: torch.Tensor,  # (M, 4) cumulative gyro rotation table
    imu_valid_count: torch.Tensor,  # () int32 valid table entries
    ref_time: torch.Tensor,  # () rotation reference time
) -> torch.Tensor:
    """Rotational deskew: each point is rotated by R(ref)⁻¹ R(t_point), with
    R interpolated from the gyro-integrated attitude table."""
    M = imu_time.shape[0]
    ar = torch.arange(M, device=imu_time.device)
    t_sorted = torch.where(ar < imu_valid_count, imu_time,
                           torch.full_like(imu_time, float("inf")))
    hi = imu_valid_count.long() - 1

    def interp(t):
        idx = torch.searchsorted(t_sorted, t.contiguous(), right=True) - 1
        # jnp.clip(idx, 0, count-1); the outer clamp only matters for an
        # empty table, whose result the caller discards
        idx = torch.clamp(torch.minimum(torch.clamp(idx, min=0), hi), min=0)
        nxt = torch.clamp(torch.minimum(idx + 1, hi), min=0)
        t0 = t_sorted[idx]
        t1n = t_sorted[nxt]
        t1 = torch.where(torch.isfinite(t1n), t1n, t0)
        ratio = torch.where(t1 > t0, (t - t0) / torch.clamp(t1 - t0, min=1e-12),
                            torch.zeros_like(t))
        ratio = torch.clamp(ratio, 0.0, 1.0)
        return lie.quat_slerp(imu_quat[idx], imu_quat[nxt], ratio[..., None])

    q_pts = interp(rel_time)
    q_ref = interp(ref_time.reshape(1))[0]
    q_corr = lie.quat_multiply(lie.quat_conjugate(q_ref).expand_as(q_pts), q_pts)
    return lie.quat_rotate(q_corr, xyz)


def compact_rings(valid_img: torch.Tensor, horizon_scan: int):
    """Ring-major compaction order: per ring, valid cells packed left
    preserving column order. Returns (order (N,H), counts (N,),
    start_idx (N,), end_idx (N,)) with the reference's ±5 margins."""
    n_scan = valid_img.shape[0]
    dev = valid_img.device
    incl = torch.cumsum(valid_img.to(torch.int32), dim=1, dtype=torch.int32)
    counts = incl[:, -1]
    dest = torch.where(valid_img, incl - 1,
                       torch.full_like(incl, horizon_scan)).long()
    col = torch.arange(horizon_scan, dtype=torch.int32,
                       device=dev)[None, :].expand(n_scan, horizon_scan)
    order = torch.zeros((n_scan, horizon_scan + 1), dtype=torch.int32, device=dev)
    order.scatter_(1, dest, col)  # unique per valid cell; trash column last
    order = order[:, :horizon_scan]
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.cumsum(counts, 0, dtype=torch.int32)])
    start_idx = cum[:-1] - 1 + 5
    end_idx = cum[1:] - 1 - 5
    return order, counts, start_idx, end_idx


def project_compact(
    xyz: torch.Tensor,  # (P, 3) (deskewed) points
    intensity: torch.Tensor,  # (P,)
    ring: torch.Tensor,  # (P,) int32
    valid: torch.Tensor,  # (P,) bool
    n_scan: int,
    horizon_scan: int,
    min_range: float,
    max_range: float,
    columns: torch.Tensor | None = None,
    downsample_rate: int = 1,
):
    """Range-image projection (first point wins per cell) fused with the
    ring compaction. Returns (flat_xyz (N*H,3), flat_int, flat_rng,
    flat_col int32, flat_valid, counts (N,), start_idx (N,), end_idx (N,));
    entries past each ring's count are masked junk."""
    P = xyz.shape[0]
    dev = xyz.device
    rng = lie.norm3(xyz)
    ok = valid & (rng >= min_range) & (rng <= max_range)
    ok &= (ring >= 0) & (ring < n_scan)
    if downsample_rate > 1:
        ok &= (ring % downsample_rate) == 0
    unique_cols = columns is None
    if columns is None:
        columns = livox_columns(ring, ok, n_scan)
    ok &= (columns >= 0) & (columns < horizon_scan)
    trash = n_scan * horizon_scan
    flat_cell = torch.where(ok, ring * horizon_scan + columns,
                            torch.full_like(ring, trash)).long()
    pidx = torch.arange(P, dtype=torch.int32, device=dev)

    if unique_cols:
        # Livox counter columns are unique per ring, so the first-wins dedup
        # and the left-compaction are both the identity: one unique-index
        # scatter
        winner = set_rows(torch.full((trash,), P, dtype=torch.int32, device=dev),
                          flat_cell, pidx).reshape(n_scan, horizon_scan)
        counts = torch.sum(
            ok[None, :] & (ring[None, :] == torch.arange(n_scan, device=dev)[:, None]),
            dim=-1,
        ).to(torch.int32)
        hh = torch.arange(horizon_scan, dtype=torch.int32, device=dev)[None, :]
        order = torch.where(hh < counts[:, None], hh, torch.zeros_like(hh))
        cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
        start_idx = cum[:-1] - 1 + 5
        end_idx = cum[1:] - 1 - 5
        gidx = torch.clamp(winner.reshape(-1), 0, P - 1)
    else:
        # general path (spherical columns collide): scatter-min of point
        # index per cell, an integer reduction and so order-free
        winner = torch.full((trash + 1,), P, dtype=torch.int32, device=dev)
        winner = winner.scatter_reduce(0, flat_cell, pidx, reduce="amin")
        winner = winner[:-1].reshape(n_scan, horizon_scan)
        valid_img = winner < P
        order, counts, start_idx, end_idx = compact_rings(valid_img, horizon_scan)
        gidx = torch.gather(winner, 1, order.long()).reshape(-1)
        gidx = torch.clamp(gidx, 0, P - 1)
    flat_valid = (
        torch.arange(horizon_scan, dtype=torch.int32, device=dev)[None, :]
        < counts[:, None]
    ).reshape(-1)
    data = torch.cat([xyz, rng[:, None], intensity[:, None]], dim=-1)
    flat = data[gidx.long()]
    flat_rng = torch.where(flat_valid, flat[:, 3], torch.zeros_like(flat[:, 3]))
    return (
        flat[:, 0:3], flat[:, 4], flat_rng, order.reshape(-1),
        flat_valid, counts, start_idx, end_idx,
    )


def gather_compacted(order: torch.Tensor, counts: torch.Tensor, img: torch.Tensor):
    """Apply the compaction order to a (N, H, ...) image and flatten it to
    (N*H, ...) with its validity mask."""
    n_scan, h = order.shape
    flat = torch.gather(img.reshape(n_scan, h, -1), 1,
                        order.long()[..., None].expand(n_scan, h, img.reshape(n_scan, h, -1).shape[-1]))
    valid = torch.arange(h, device=order.device)[None, :] < counts[:, None]
    out = flat.reshape(n_scan * h, -1)
    if img.dim() == 2:
        out = out[:, 0]
    return out, valid.reshape(-1)


def _voxel_keys(xyz: torch.Tensor, valid: torch.Tensor, leaf: float):
    """Quantized voxel coordinates packed into one int32 key; invalid points
    get the sentinel key 2^31-1 (sorts last)."""
    c = torch.floor(xyz / leaf).to(torch.int32) + (1 << 9)
    c = torch.clamp(c, 0, (1 << 10) - 1)
    key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    return torch.where(valid, key, torch.full_like(key, _KEY_SENTINEL))


def voxel_downsample(
    xyz: torch.Tensor,  # (P, 3)
    valid: torch.Tensor,  # (P,)
    leaf: float,
    capacity: int,
    intensity: torch.Tensor | None = None,
    center: torch.Tensor | None = None,
):
    """PCL VoxelGrid equivalent: the centroid of the points in each occupied
    voxel. Returns (xyz_out (capacity,3), valid_out (capacity,),
    intensity_out). Voxels beyond `capacity` are dropped by key order, or,
    with `center`, farthest-from-center first. Inputs of at most 4096 points
    take the sort-free dense path."""
    if center is None and xyz.shape[0] <= 4096:
        return _voxel_downsample_dense(xyz, valid, leaf, capacity, intensity)
    dev = xyz.device
    P = xyz.shape[0]
    keys = _voxel_keys(xyz, valid, leaf)
    if center is not None:
        # distance of each point's VOXEL CENTER to `center`, in leaf units
        c = torch.floor(xyz / leaf) + 0.5
        d = lie.norm3(c * leaf - center[None, :])
        dq = torch.where(valid, (d / leaf).to(torch.int32),
                         torch.full_like(keys, _KEY_SENTINEL))
        # lexsort((keys, dq)): primary dq, ties by key — two stable sorts
        o1 = torch.sort(keys, stable=True).indices
        o2 = torch.sort(dq[o1], stable=True).indices
        order = o1[o2]
    else:
        order = torch.sort(keys, stable=True).indices
    ks = keys[order]
    xs = xyz[order]
    vs = valid[order]
    ins = (intensity[order] if intensity is not None
           else torch.zeros(P, dtype=xyz.dtype, device=dev))

    is_first = torch.ones(P, dtype=torch.bool, device=dev)
    is_first[1:] = ks[1:] != ks[:-1]
    is_first &= vs
    seg_id = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1

    n_seg = capacity
    # valid points are sorted first, so `sid` is non-decreasing: overflow
    # segments and invalid points all land in the trash segment n_seg
    sid = torch.where(vs & (seg_id < n_seg), seg_id,
                      torch.full_like(seg_id, n_seg)).long()
    data = torch.cat([xs, ins[:, None]], dim=-1)
    sums = segment_sum(data, sid, n_seg + 1)
    cnts = torch.bincount(sid, minlength=n_seg + 1)
    total_seg = torch.sum(is_first, dtype=torch.int32)
    out_valid = torch.arange(n_seg, device=dev) < torch.clamp(total_seg, max=n_seg)
    denom = torch.clamp(cnts[:n_seg], min=1).to(xyz.dtype)[:, None]
    cent = sums[:n_seg] / denom
    out_xyz = torch.where(out_valid[:, None], cent[:, :3], torch.zeros_like(cent[:, :3]))
    out_int = torch.where(out_valid, cent[:, 3], torch.zeros_like(cent[:, 3]))
    return out_xyz, out_valid, out_int


def _voxel_downsample_dense(xyz, valid, leaf: float, capacity: int,
                            intensity=None):
    """Sort-free voxel centroid downsample for small clouds: pairwise key
    equality (P, P), one full-f32 matmul for the segment sums, and a
    prefix-sum compaction of the first-occurrence rows (output ordered by
    first occurrence)."""
    P = xyz.shape[0]
    dev = xyz.device
    keys = _voxel_keys(xyz, valid, leaf)
    eq = (keys[:, None] == keys[None, :]) & valid[None, :] & valid[:, None]
    idx = torch.arange(P, dtype=torch.int32, device=dev)
    earlier = idx[None, :] < idx[:, None]
    first = valid & ~torch.any(eq & earlier, dim=1)

    ins = intensity if intensity is not None else torch.zeros(P, dtype=xyz.dtype, device=dev)
    data = torch.cat([xyz, ins[:, None]], dim=-1)
    sums = eq.to(xyz.dtype) @ data
    cnts = torch.sum(eq.to(torch.int32), dim=1)
    cent = sums / torch.clamp(cnts, min=1).to(xyz.dtype)[:, None]

    f32 = first.to(torch.int32)
    rank = torch.cumsum(f32, 0, dtype=torch.int32) - f32
    slot = torch.where(first & (rank < capacity), rank,
                       torch.full_like(rank, capacity))
    out = set_rows(torch.zeros((capacity, 4), dtype=xyz.dtype, device=dev),
                   slot, cent)
    n_vox = torch.sum(f32, dtype=torch.int32)
    out_valid = torch.arange(capacity, device=dev) < torch.clamp(n_vox, max=capacity)
    out_xyz = torch.where(out_valid[:, None], out[:, :3], torch.zeros_like(out[:, :3]))
    out_int = torch.where(out_valid, out[:, 3], torch.zeros_like(out[:, 3]))
    return out_xyz, out_valid, out_int


def remove_ego_points(xyz: torch.Tensor, valid: torch.Tensor, min_range: float) -> torch.Tensor:
    """Drop points closer than min_range (ego returns)."""
    return valid & (lie.norm3(xyz) >= min_range)


def transform_cloud(t: torch.Tensor, q: torch.Tensor, xyz: torch.Tensor):
    """Rigid transform of a padded cloud."""
    return lie.quat_rotate(q[None, :], xyz) + t[None, :]
