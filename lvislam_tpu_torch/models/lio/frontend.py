"""LIS front end — port of ``lvislam_tpu.models.lio.frontend``: scan
projection + deskew (``imageProjection``) and LOAM feature extraction
(``featureExtraction``) as two plain functions over fixed-shape tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import loam, pointcloud as pc
from ...ops.segment import set_rows
from ...ops.preintegration import gyro_rotation_table


class ProjectionResult(NamedTuple):
    xyz: torch.Tensor  # (P, 3) deskewed, compacted ring-major
    intensity: torch.Tensor  # (P,)
    valid: torch.Tensor  # (P,)
    point_col: torch.Tensor  # (P,) int32
    point_range: torch.Tensor  # (P,)
    start_ring_index: torch.Tensor  # (R,)
    end_ring_index: torch.Tensor  # (R,)
    imu_available: torch.Tensor  # () bool
    imu_rpy_init: torch.Tensor  # (3,)
    num_valid: torch.Tensor  # () int32


def project_scan(
    xyz, intensity, ring, rel_time, point_valid,
    imu_rel_time, imu_gyro, imu_count, imu_rpy_init, imu_available,
    n_scan: int, horizon: int,
    min_range: float = 1.0, max_range: float = 100.0,
    downsample_rate: int = 1,
) -> ProjectionResult:
    """Deskew + range-image projection + ring compaction."""
    M = imu_rel_time.shape[0]
    dts = torch.diff(imu_rel_time, prepend=imu_rel_time[0:1])
    dts = torch.where(torch.arange(M, device=dts.device) < imu_count, dts,
                      torch.zeros_like(dts))
    quat_table = gyro_rotation_table(dts, imu_gyro)[1:]

    # rotation reference = first valid point (first max, as jnp.argmax)
    first_idx = torch.argmax(point_valid.to(torch.int32))
    ref_time = rel_time[first_idx]

    do_deskew = imu_available & (imu_count > 1)
    deskewed = pc.deskew_points(xyz, rel_time, imu_rel_time, quat_table,
                                imu_count, ref_time)
    xyz_d = torch.where(do_deskew, deskewed, xyz)

    (flat_xyz, flat_int, flat_rng, flat_col, flat_valid,
     _counts, start_idx, end_idx) = pc.project_compact(
        xyz_d, intensity, ring, point_valid, n_scan, horizon,
        min_range, max_range, columns=None, downsample_rate=downsample_rate,
    )
    return ProjectionResult(
        xyz=flat_xyz,
        intensity=flat_int,
        valid=flat_valid,
        point_col=flat_col,
        point_range=flat_rng,
        start_ring_index=start_idx.to(torch.int32),
        end_ring_index=end_idx.to(torch.int32),
        imu_available=imu_available,
        imu_rpy_init=imu_rpy_init,
        num_valid=torch.sum(flat_valid, dtype=torch.int32),
    )


class FeatureResult(NamedTuple):
    corner_xyz: torch.Tensor  # (C, 3)
    corner_valid: torch.Tensor  # (C,)
    surf_xyz: torch.Tensor  # (S, 3)
    surf_valid: torch.Tensor  # (S,)
    num_corner: torch.Tensor  # ()
    num_surf: torch.Tensor  # ()


def extract_features(
    proj: ProjectionResult,
    edge_threshold: float = 1.0,
    surf_threshold: float = 0.1,
    surf_leaf: float = 0.4,
    max_corner: int = 1024,
    max_surf: int = 8192,
    exact_selection: bool = False,
) -> FeatureResult:
    """LOAM feature selection: the vectorized edge pick, or with
    `exact_selection` the reference's sequential greedy pick
    (`loam.select_edges`, 240 rounds)."""
    curv = loam.curvature(proj.point_range, proj.valid)
    occl = loam.occlusion_mask(proj.point_range, proj.point_col, proj.valid)
    select = loam.select_edges if exact_selection else loam.select_edges_fast
    edges = select(
        curv, proj.point_col, occl, proj.valid,
        proj.start_ring_index, proj.end_ring_index, edge_threshold,
    )
    # order-preserving compaction of the edge points to capacity
    e32 = edges.to(torch.int32)
    n_edges = torch.sum(e32, dtype=torch.int32)
    dest = torch.cumsum(e32, 0, dtype=torch.int32) - e32
    slot = torch.where(edges, dest, torch.full_like(dest, max_corner))
    dev = edges.device
    eidx = set_rows(torch.zeros(max_corner, dtype=torch.long, device=dev), slot,
                    torch.arange(edges.shape[0], device=dev))
    corner_xyz = proj.xyz[eidx]
    corner_valid = torch.arange(max_corner, device=dev) < n_edges

    surf_mask = loam.surface_candidates(edges, proj.valid)
    surf_xyz, surf_valid, _ = pc.voxel_downsample(
        proj.xyz, surf_mask, surf_leaf, max_surf, proj.intensity
    )
    return FeatureResult(
        corner_xyz=corner_xyz,
        corner_valid=corner_valid,
        surf_xyz=surf_xyz,
        surf_valid=surf_valid,
        num_corner=torch.sum(edges, dtype=torch.int32),
        num_surf=torch.sum(surf_valid, dtype=torch.int32),
    )
