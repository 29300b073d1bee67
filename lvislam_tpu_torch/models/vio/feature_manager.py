"""Sliding-window feature table — port of
``lvislam_tpu.models.vio.feature_manager`` (the `FeatureManager`
equivalent).

A fixed-capacity table: F slots x (W+1) window frames of normalized
observations with validity masks. All bookkeeping (id matching, the parallax
keyframe test, lidar depth adoption, multi-view triangulation, window shift
with depth re-anchoring) is vectorized over slots. A window frame index may
be a Python int or a () tensor: a column is written by a mask over the frame
axis and read by ``index_select``, so neither form reads a value back.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ...core import lie
from ...core.device import resolve as resolve_device
from ...ops import triangulate as tri


@dataclasses.dataclass(frozen=True)
class VioCaps:
    window: int = 10  # WINDOW_SIZE
    max_features: int = 512
    imu_buf: int = 64  # IMU samples per inter-frame interval
    frame_features: int = 150  # MAX_CNT incoming per frame
    ex_pairs: int = 24  # hand-eye calibration pair ring


class FeatureTable(NamedTuple):
    ids: torch.Tensor  # (F,) int32, -1 = free
    start_frame: torch.Tensor  # (F,) int32
    obs: torch.Tensor  # (F, W+1, 2) normalized plane coords
    vel: torch.Tensor  # (F, W+1, 2)
    obs_valid: torch.Tensor  # (F, W+1)
    inv_depth: torch.Tensor  # (F,) inverse depth in start frame; <=0 = uninit
    lidar_flag: torch.Tensor  # (F,) depth came from lidar (held constant in BA)
    rt: torch.Tensor  # (F, W+1) rolling-shutter row readout time, seconds


def table_init(caps: VioCaps, dtype=torch.float32, device=None) -> FeatureTable:
    """The empty table on `device` (the card unless named)."""
    device = resolve_device(device)
    F, W1 = caps.max_features, caps.window + 1
    return FeatureTable(
        ids=torch.full((F,), -1, dtype=torch.int32, device=device),
        start_frame=torch.zeros(F, dtype=torch.int32, device=device),
        obs=torch.zeros((F, W1, 2), dtype=dtype, device=device),
        vel=torch.zeros((F, W1, 2), dtype=dtype, device=device),
        obs_valid=torch.zeros((F, W1), dtype=torch.bool, device=device),
        inv_depth=torch.full((F,), -1.0, dtype=dtype, device=device),
        lidar_flag=torch.zeros(F, dtype=torch.bool, device=device),
        rt=torch.zeros((F, W1), dtype=dtype, device=device),
    )


def column(x: torch.Tensor, k) -> torch.Tensor:
    """x[:, k] for an int or a () tensor k."""
    if isinstance(k, int):
        return x[:, k]
    return torch.index_select(x, 1, k.reshape(1).long())[:, 0]


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along `dim` (0 where none), as ``jnp.argmax``
    of a boolean array."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _clamp_min0(k):
    return max(k, 0) if isinstance(k, int) else torch.clamp(k, min=0)


def add_frame(
    table: FeatureTable,
    frame_idx,  # current window frame index (<= W): int or () tensor
    in_ids: torch.Tensor,  # (N,) incoming feature ids (-1 invalid)
    in_norm: torch.Tensor,  # (N, 2)
    in_vel: torch.Tensor,  # (N, 2)
    in_depth: torch.Tensor,  # (N,) lidar depth (-1 none)
    in_valid: torch.Tensor,  # (N,)
    caps: VioCaps,
    min_parallax: float = 10.0 / 460.0,
    in_rt: torch.Tensor | None = None,  # (N,) rolling-shutter row time, seconds
):
    """`addFeatureCheckParallax`: insert the frame's observations and decide
    keyframe-ness by mean compensated parallax between frames W-1 and W-2.
    Returns (table, is_keyframe)."""
    Fcap = caps.max_features
    W1 = table.obs.shape[1]
    device = table.ids.device

    # match incoming ids against table slots: (F, N) equality
    eq = (table.ids[:, None] == in_ids[None, :]) & (table.ids[:, None] >= 0)
    eq = eq & in_valid[None, :]
    matched_slot = torch.any(eq, dim=1)  # (F,) slot receives an obs
    src = _first_true(eq, 1)  # (F,) which incoming row

    # new features: incoming ids with no matching slot
    is_new = in_valid & (in_ids >= 0) & (~torch.any(eq, dim=0))
    free = table.ids < 0
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    # slot i takes the new feature whose rank equals the slot's free rank
    take_new = free & (free_rank < torch.sum(is_new))
    # mapping rank -> incoming index: new features first, in index order
    order = torch.sort((~is_new).to(torch.uint8), stable=True).indices
    n_in = in_ids.shape[0]
    src_new = order[torch.clamp(free_rank, 0, min(Fcap, n_in) - 1).long()]

    fi = frame_idx
    at_fi = torch.arange(W1, device=device) == fi  # (W+1,)

    def put(buf, new_rows, matched_rows, zero):
        row = torch.where(
            take_new.reshape((-1,) + (1,) * (new_rows.dim() - 1)), new_rows,
            torch.where(matched_slot.reshape((-1,) + (1,) * (new_rows.dim() - 1)),
                        matched_rows, zero))
        sel = at_fi.reshape((1, W1) + (1,) * (new_rows.dim() - 1))
        return torch.where(sel, row[:, None], buf)

    z = torch.zeros((), dtype=table.obs.dtype, device=device)
    obs = put(table.obs, in_norm[src_new], in_norm[src], z)
    vel = put(table.vel, in_vel[src_new], in_vel[src], z)
    obs_valid = torch.where(at_fi[None, :], (matched_slot | take_new)[:, None], table.obs_valid)
    if in_rt is None:
        in_rt = torch.zeros(n_in, dtype=table.rt.dtype, device=device)
    rt = put(table.rt, in_rt[src_new], in_rt[src], z)

    ids = torch.where(take_new, in_ids[src_new], table.ids)
    fi32 = torch.as_tensor(fi, dtype=torch.int32, device=device)
    start_frame = torch.where(take_new, fi32, table.start_frame)
    # lidar depth adoption: only when the feature starts at this frame and
    # lidar depth is valid
    new_depth = in_depth[src_new]
    minus1 = torch.full_like(table.inv_depth, -1.0)
    inv_depth = torch.where(
        take_new & (new_depth > 0), 1.0 / torch.clamp(new_depth, min=1e-3),
        torch.where(take_new, minus1, table.inv_depth),
    )
    lidar_flag = torch.where(take_new, new_depth > 0, table.lidar_flag)
    # matched features may also adopt lidar depth if not yet solved
    m_depth = in_depth[src]
    adopt = matched_slot & (table.start_frame == fi) & (m_depth > 0) & (~table.lidar_flag)
    inv_depth = torch.where(adopt, 1.0 / torch.clamp(m_depth, min=1e-3), inv_depth)
    lidar_flag = lidar_flag | adopt

    new_table = FeatureTable(
        ids=ids, start_frame=start_frame, obs=obs, vel=vel,
        obs_valid=obs_valid, inv_depth=inv_depth, lidar_flag=lidar_flag, rt=rt,
    )

    # ---- parallax keyframe test ----
    # compensated parallax of features observed in both frame_idx-2 and -1
    f1 = _clamp_min0(fi - 1)
    f2 = _clamp_min0(fi - 2)
    seen = column(obs_valid, f1) & column(obs_valid, f2) & (ids >= 0)
    d = column(obs, f1) - column(obs, f2)
    par = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    n_par = torch.sum(seen)
    mean_par = torch.sum(torch.where(seen, par, z)) / torch.clamp(n_par, min=1)
    # keyframe if frame_count < 2, few long tracks, or parallax
    long_track = torch.sum((table.ids >= 0) & matched_slot)
    is_kf = (fi32 < 2) | (long_track < 20) | (mean_par >= min_parallax)
    return new_table, is_kf


def _fix_anchors(table: FeatureTable) -> FeatureTable:
    """Re-anchor features whose start-frame observation vanished in a slide:
    start_frame := first valid obs; a moved anchor invalidates the depth
    (re-triangulated on the next solve)."""
    has = torch.any(table.obs_valid, dim=1)
    first = _first_true(table.obs_valid, 1).to(torch.int32)
    moved = has & (first != table.start_frame)
    return table._replace(
        start_frame=torch.where(has, first, table.start_frame),
        inv_depth=torch.where(moved, torch.full_like(table.inv_depth, -1.0), table.inv_depth),
        lidar_flag=table.lidar_flag & (~moved),
    )


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def slide_old(
    table: FeatureTable,
    P0_new: torch.Tensor,  # marg frame camera position (world<-cam)
    R0_marg: torch.Tensor,  # (3, 3)
    P1_new: torch.Tensor,  # new frame-0 camera position
    R1_new: torch.Tensor,
    caps: VioCaps,
) -> FeatureTable:
    """MARGIN_OLD shift: drop frame 0, shift all observations left; features
    anchored at frame 0 re-anchor to the new frame 0 with depth re-projected
    through both camera poses."""
    Fcap = table.obs.shape[0]
    anchored0 = (table.ids >= 0) & (table.start_frame == 0)
    first_obs = table.obs[:, 0]

    obs, vel = _shift_left(table.obs), _shift_left(table.vel)
    obs_valid, rt = _shift_left(table.obs_valid), _shift_left(table.rt)
    start_frame = torch.clamp(table.start_frame - 1, min=0)

    # depth re-anchoring for features anchored at old frame 0 that survive
    survives = anchored0 & obs_valid[:, 0]
    depth = 1.0 / torch.clamp(table.inv_depth, min=1e-6)
    pts_cam0 = torch.cat(
        [first_obs, torch.ones((Fcap, 1), dtype=first_obs.dtype, device=first_obs.device)],
        dim=-1) * depth[:, None]
    pts_w = pts_cam0 @ R0_marg.T + P0_new[None, :]
    pts_cam1 = (pts_w - P1_new[None, :]) @ R1_new
    new_depth = pts_cam1[:, 2]
    minus1 = torch.full_like(table.inv_depth, -1.0)
    new_inv = torch.where(new_depth > 0.1, 1.0 / new_depth, minus1)
    inv_depth = torch.where(
        survives & (table.inv_depth > 0), new_inv,
        torch.where(anchored0, minus1, table.inv_depth),
    )

    # drop features with no remaining observations
    alive = (table.ids >= 0) & torch.any(obs_valid, dim=1)
    ids = torch.where(alive, table.ids, torch.full_like(table.ids, -1))
    return _fix_anchors(FeatureTable(
        ids=ids, start_frame=start_frame, obs=obs, vel=vel,
        obs_valid=obs_valid, inv_depth=torch.where(alive, inv_depth, minus1),
        lidar_flag=table.lidar_flag & alive, rt=rt,
    ))


def slide_new(table: FeatureTable, caps: VioCaps) -> FeatureTable:
    """MARGIN_SECOND_NEW: frame W-1's observations vanish; frame W moves into
    slot W-1."""
    W = caps.window

    def move(x):  # column W -> W-1, column W cleared
        return torch.cat([x[:, :W - 1], x[:, W:W + 1], torch.zeros_like(x[:, W:W + 1])], dim=1)

    obs_valid = move(table.obs_valid)
    start_frame = torch.where(table.start_frame == W,
                              torch.full_like(table.start_frame, W - 1), table.start_frame)
    alive = (table.ids >= 0) & torch.any(obs_valid, dim=1)
    return _fix_anchors(table._replace(
        ids=torch.where(alive, table.ids, torch.full_like(table.ids, -1)),
        start_frame=start_frame,
        obs=move(table.obs), vel=move(table.vel), obs_valid=obs_valid, rt=move(table.rt),
        inv_depth=torch.where(alive, table.inv_depth, torch.full_like(table.inv_depth, -1.0)),
        lidar_flag=table.lidar_flag & alive,
    ))


def triangulate_all(
    table: FeatureTable,
    Ps: torch.Tensor,  # (W+1, 3) body positions (world)
    Qs: torch.Tensor,  # (W+1, 4) body orientations
    tic: torch.Tensor,  # (3,) imu->cam translation
    qic: torch.Tensor,  # (4,)
    caps: VioCaps,
) -> FeatureTable:
    """Triangulate features without depth: multi-view DLT per feature in its
    start-frame camera, all features in one batch; INIT_DEPTH = 5 where it
    fails."""
    # camera poses per frame: T_wc = T_wb * T_bc
    t_wc, q_wc = lie.se3_compose(Ps, Qs, tic, qic)
    R_wc = lie.quat_to_matrix(q_wc)  # (K, 3, 3)
    R_cw = R_wc.transpose(-1, -2)
    t_cw = -(R_cw @ t_wc[..., None])[..., 0]

    # express all views relative to each feature's start-frame camera:
    # world->cam_k composed with cam0->world: R_k (R0 x + t0) + t_k
    sf = table.start_frame.long()
    R0, t0 = R_wc[sf], t_wc[sf]  # (F, 3, 3), (F, 3)
    Rrel = R_cw[None] @ R0[:, None]  # (F, K, 3, 3)
    trel = (R_cw[None] @ t0[:, None, :, None])[..., 0] + t_cw[None]
    _, depths = tri.triangulate_multiview(Rrel, trel, table.obs, table.obs_valid)

    need = (table.ids >= 0) & (table.inv_depth <= 0) & (torch.sum(table.obs_valid, dim=1) >= 2)
    inv = torch.where(depths > 0.1, 1.0 / depths, torch.full_like(depths, 1.0 / 5.0))
    return table._replace(inv_depth=torch.where(need, inv, table.inv_depth))
