"""LIS map optimization — port of ``lvislam_tpu.models.lio.mapping``:
keyframe mapping, scan-to-map registration, the pose graph, GPS factors and
loop closure over one fixed-shape ``LioMapState`` of device tensors.

Where the JAX step branches on the device (``lax.cond``), the port takes
cheap branches branch-free with ``torch.where`` and expensive ones (the GN
solve, keyframe insertion, map rebuild, graph optimization, loop closure) as
Python branches on one host read each (``core.hostsync``). The state is
never updated in place: every step returns new tensors, as the JAX step
does, so a caller's reference to an older state stays valid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ...core import lie
from ...core.device import resolve as resolve_device
from ...core.hostsync import host_bool, host_int
from ...ops import icp as icp_ops
from ...ops import pointcloud as pc
from ...ops import posegraph as pg
from ...ops import scan2map
from ...ops import voxel_hash as vh
from ...ops.segment import scatter_add, scatter_set, set_rows
from .frontend import FeatureResult


@dataclasses.dataclass(frozen=True)
class LioCaps:
    """Static capacities (field for field the JAX ``LioCaps``)."""

    max_keyframes: int = 512
    kf_corner: int = 512
    kf_surf: int = 2048
    sel_keyframes: int = 48
    map_corner: int = 16384
    map_surf: int = 65536
    scan_corner: int = 1024
    scan_surf: int = 4096
    max_loops: int = 32
    max_gps: int = 64
    loop_submap: int = 16384
    icp_iters: int = 25
    corner_hash_size: int = 1 << 14
    surf_hash_size: int = 1 << 16
    hash_bucket: int = 32
    surf_hash_bucket: int = 16
    # route the voxel-hash query tail through kernel K1 (ops.knn_tail)
    pallas_knn: bool = False
    # route coefficients + normal equations through kernel K2
    # (ops.gn_partials)
    pallas_gn: bool = False
    corner_leaf_table: int = 1 << 15
    surf_leaf_table: int = 1 << 17


@dataclasses.dataclass(frozen=True)
class LioParams:
    """Dynamic-value parameters (field for field the JAX ``LioParams``)."""

    mappingCornerLeafSize: float = 0.2
    mappingSurfLeafSize: float = 0.4
    surroundingKeyframeSearchRadius: float = 50.0
    keyframeAddingDistThreshold: float = 1.0
    keyframeAddingAngleThreshold: float = 0.2
    imuRPYWeight: float = 0.01
    z_tollerance: float = 1000.0
    rotation_tollerance: float = 1000.0
    useImuHeadingInitialization: bool = False
    livox_keyframe_interval: float = 1.0
    historyKeyframeSearchRadius: float = 15.0
    historyKeyframeSearchTimeDiff: float = 30.0
    historyKeyframeSearchNum: int = 25
    historyKeyframeFitnessScore: float = 0.3
    edgeFeatureMinValidNum: int = 10
    surfFeatureMinValidNum: int = 100
    gpsCovThreshold: float = 2.0
    poseCovThreshold: float = 25.0
    degeneracyEigenThreshold: float = 100.0
    nnRefreshEvery: int = 1
    gatherOncePerScan: bool = False
    mapRebuildEvery: int = 1
    constantVelocityGuess: bool = True
    vinsGuessMaxDeltaJump: float = 0.5
    vinsGuessMaxRotRate: float = 3.0


class LioMapState(NamedTuple):
    """Field for field the JAX ``LioMapState`` (see it for the meaning of
    each field)."""

    x6: torch.Tensor
    kf_trans: torch.Tensor
    kf_quat: torch.Tensor
    kf_time: torch.Tensor
    kf_count: torch.Tensor
    kf_corner: torch.Tensor
    kf_corner_valid: torch.Tensor
    kf_surf: torch.Tensor
    kf_surf_valid: torch.Tensor
    graph: pg.PoseGraph
    n_loops: torch.Tensor
    loop_pending: torch.Tensor
    last_loop_kf: torch.Tensor
    last_imu_rpy: torch.Tensor
    last_imu_valid: torch.Tensor
    last_vins_trans: torch.Tensor
    last_vins_quat: torch.Tensor
    last_vins_valid: torch.Tensor
    vins_reset_id: torch.Tensor
    incr_x6: torch.Tensor
    degenerate: torch.Tensor
    last_scan_stamp: torch.Tensor
    last_gn_ok: torch.Tensor
    last_delta_t: torch.Tensor
    last_delta_q: torch.Tensor
    last_gps_pos: torch.Tensor
    has_gps: torch.Tensor
    n_gps: torch.Tensor
    pose_cov_xy: torch.Tensor
    yaw_var: torch.Tensor
    pose_cov_cross: torch.Tensor
    kf_cov_xy: torch.Tensor
    kf_yaw_var: torch.Tensor
    kf_cov_cross: torch.Tensor
    map_corner: torch.Tensor
    map_corner_valid: torch.Tensor
    map_surf: torch.Tensor
    map_surf_valid: torch.Tensor
    corner_hash: vh.VoxelHash
    surf_hash: vh.VoxelHash
    map_corner_n: torch.Tensor
    map_surf_n: torch.Tensor
    kf_since_rebuild: torch.Tensor
    leaf_occ_corner: torch.Tensor
    leaf_occ_surf: torch.Tensor
    leaf_row_corner: torch.Tensor
    leaf_row_surf: torch.Tensor
    map_corner_accum: torch.Tensor
    map_corner_cnt: torch.Tensor
    map_surf_accum: torch.Tensor
    map_surf_cnt: torch.Tensor


class MapOutputs(NamedTuple):
    x6: torch.Tensor
    incr_x6: torch.Tensor
    degenerate: torch.Tensor
    is_keyframe: torch.Tensor
    num_residuals: torch.Tensor
    gn_iters: torch.Tensor


def lio_init(caps: LioCaps, device=None, dtype=torch.float32) -> LioMapState:
    """The empty map state on `device` (the card unless named)."""
    K = caps.max_keyframes
    dev = resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=dev)

    def scalar(v, dt):
        return torch.tensor(v, dtype=dt, device=dev)

    qi = lie.quat_identity(dtype, dev)
    i32, b = torch.int32, torch.bool
    return LioMapState(
        x6=z(6), kf_trans=z(K, 3), kf_quat=qi.repeat(K, 1), kf_time=z(K),
        kf_count=scalar(0, i32),
        kf_corner=z(K, caps.kf_corner, 3), kf_corner_valid=z(K, caps.kf_corner, dt=b),
        kf_surf=z(K, caps.kf_surf, 3), kf_surf_valid=z(K, caps.kf_surf, dt=b),
        graph=pg.empty_graph(K, K + caps.max_loops, caps.max_gps, dtype, dev),
        n_loops=scalar(0, i32), loop_pending=scalar(False, b),
        last_loop_kf=scalar(-1, i32),
        last_imu_rpy=z(3), last_imu_valid=scalar(False, b),
        last_vins_trans=z(3), last_vins_quat=qi.clone(),
        last_vins_valid=scalar(False, b), vins_reset_id=scalar(0, i32),
        incr_x6=z(6), degenerate=scalar(False, b),
        last_scan_stamp=scalar(-1.0, dtype), last_gn_ok=scalar(False, b),
        last_delta_t=z(3), last_delta_q=qi.clone(),
        last_gps_pos=z(3), has_gps=scalar(False, b), n_gps=scalar(0, i32),
        pose_cov_xy=scalar(1e8, dtype), yaw_var=scalar(9.8696044, dtype),
        pose_cov_cross=scalar(0.0, dtype),
        kf_cov_xy=full((K,), 1e8), kf_yaw_var=full((K,), 9.8696044),
        kf_cov_cross=z(K),
        map_corner=z(caps.map_corner, 3), map_corner_valid=z(caps.map_corner, dt=b),
        map_surf=z(caps.map_surf, 3), map_surf_valid=z(caps.map_surf, dt=b),
        corner_hash=vh.build(z(caps.map_corner, 3), z(caps.map_corner, dt=b),
                             1.0, caps.corner_hash_size, caps.hash_bucket),
        surf_hash=vh.build(z(caps.map_surf, 3), z(caps.map_surf, dt=b),
                           1.0, caps.surf_hash_size, caps.surf_hash_bucket),
        map_corner_n=scalar(0, i32), map_surf_n=scalar(0, i32),
        kf_since_rebuild=scalar(0, i32),
        leaf_occ_corner=full((caps.corner_leaf_table,), -1, torch.int16),
        leaf_occ_surf=full((caps.surf_leaf_table,), -1, torch.int16),
        leaf_row_corner=full((caps.corner_leaf_table,), -1, i32),
        leaf_row_surf=full((caps.surf_leaf_table,), -1, i32),
        map_corner_accum=z(caps.map_corner, 3), map_corner_cnt=z(caps.map_corner),
        map_surf_accum=z(caps.map_surf, 3), map_surf_cnt=z(caps.map_surf),
    )


def _at(arr: torch.Tensor, i, v) -> torch.Tensor:
    """Out-of-place ``arr.at[i].set(v)`` for one index (int or 0-d tensor)."""
    out = arr.clone()
    out[i] = torch.as_tensor(v, dtype=arr.dtype, device=arr.device)
    return out


def _x6_to_tq(x6):
    return x6[3:6], lie.matrix_to_quat(lie.x6_rotation(x6))


def _tq_to_x6(t, q):
    ypr = lie.matrix_to_ypr(lie.quat_to_matrix(q)) * (math.pi / 180.0)
    return torch.cat([torch.stack([ypr[2], ypr[1], ypr[0]]), t])


def _update_initial_guess(state: LioMapState, scan, params: LioParams):
    """`updateInitialGuess` (`mapOptimization.cpp:806-877`): every branch is
    cheap, so all are computed and selected with ``torch.where``."""
    imu_rpy = scan["imu_rpy_init"]
    imu_ok = scan["imu_available"]
    odom_ok = scan["odom_available"]
    odom_t, odom_q = scan["odom_trans"], scan["odom_quat"]

    # first frame
    yaw = imu_rpy[2] if params.useImuHeadingInitialization else torch.zeros_like(imu_rpy[2])
    x6_first = torch.cat([torch.stack([imu_rpy[0], imu_rpy[1], yaw]),
                          torch.zeros_like(imu_rpy)])

    # later frames: VINS increment if consistent, else IMU / const-velocity
    ti_v, qi_v = lie.se3_relative(state.last_vins_trans, state.last_vins_quat,
                                  odom_t, odom_q)
    ang_v = 2.0 * torch.arccos(torch.clamp(torch.abs(qi_v[0]), 0.0, 1.0))
    dt = torch.where(state.last_scan_stamp > 0.0,
                     torch.clamp(scan["stamp"] - state.last_scan_stamp, 1e-2, 1.0),
                     torch.full_like(state.last_scan_stamp, 0.1))
    sane = (~state.last_vins_valid) | (~state.last_gn_ok) | (
        (lie.norm3(ti_v - state.last_delta_t) < params.vinsGuessMaxDeltaJump)
        & (ang_v < params.vinsGuessMaxRotRate * dt)
    )
    vins_usable = odom_ok & (scan["odom_reset_id"] == state.vins_reset_id) & sane

    t0, q0 = _x6_to_tq(state.x6)
    x6_vins = torch.where(state.last_vins_valid,
                          _tq_to_x6(*lie.se3_compose(t0, q0, ti_v, qi_v)), state.x6)
    q_last = lie.rpy_to_quat(state.last_imu_rpy[0], state.last_imu_rpy[1],
                             state.last_imu_rpy[2])
    q_now = lie.rpy_to_quat(imu_rpy[0], imu_rpy[1], imu_rpy[2])
    qi = lie.quat_multiply(lie.quat_conjugate(q_last), q_now)
    ti = state.last_delta_t if params.constantVelocityGuess else torch.zeros_like(state.last_delta_t)
    x6_imu = torch.where(imu_ok & state.last_imu_valid,
                         _tq_to_x6(*lie.se3_compose(t0, q0, ti, qi)), state.x6)

    later_x6 = torch.where(vins_usable, x6_vins, x6_imu)
    later_valid = vins_usable
    later_t = torch.where(vins_usable | odom_ok, odom_t, state.last_vins_trans)
    later_q = torch.where(vins_usable | odom_ok, odom_q, state.last_vins_quat)
    later_reset = torch.where(vins_usable, state.vins_reset_id, scan["odom_reset_id"])

    first = state.kf_count == 0
    return state._replace(
        x6=torch.where(first, x6_first, later_x6),
        last_vins_valid=torch.where(first, state.last_vins_valid, later_valid),
        last_vins_trans=torch.where(first, state.last_vins_trans, later_t),
        last_vins_quat=torch.where(first, state.last_vins_quat, later_q),
        vins_reset_id=torch.where(first, state.vins_reset_id, later_reset),
        last_imu_rpy=torch.where(imu_ok, imu_rpy, state.last_imu_rpy),
        last_imu_valid=imu_ok | state.last_imu_valid,
        last_scan_stamp=scan["stamp"].to(torch.float32),
    )


def _assemble_local_map(state: LioMapState, caps: LioCaps, params: LioParams,
                        scan_time):
    """`extractNearby` + `extractCloud` (`mapOptimization.cpp:894-970`)."""
    K = caps.max_keyframes
    dev = state.x6.device
    cur_t = state.x6[3:6]
    kf_ok = torch.arange(K, device=dev) < state.kf_count
    d = lie.norm3(state.kf_trans - cur_t[None, :])
    recent = (scan_time - state.kf_time) < 10.0
    eligible = kf_ok & ((d < params.surroundingKeyframeSearchRadius) | recent)
    score = torch.where(eligible, -d, torch.full_like(d, -math.inf))
    # lax.top_k: largest first, ties to the lowest index
    sel = torch.sort(score, descending=True, stable=True).indices[:caps.sel_keyframes]
    sel_ok = eligible[sel]

    def gather(cloud, cvalid):
        pts = cloud[sel]
        val = cvalid[sel] & sel_ok[:, None]
        world = (lie.quat_rotate(state.kf_quat[sel][:, None, :], pts)
                 + state.kf_trans[sel][:, None, :])
        return world.reshape(-1, 3), val.reshape(-1)

    c_pts, c_val = gather(state.kf_corner, state.kf_corner_valid)
    s_pts, s_val = gather(state.kf_surf, state.kf_surf_valid)
    mc, mc_val, _ = pc.voxel_downsample(c_pts, c_val, params.mappingCornerLeafSize,
                                        caps.map_corner)
    ms, ms_val, _ = pc.voxel_downsample(s_pts, s_val, params.mappingSurfLeafSize,
                                        caps.map_surf)
    return mc, mc_val, ms, ms_val


def _transform_update(scan, params: LioParams, x6):
    """IMU roll/pitch slerp + clamps (`transformUpdate`, `:1345-1385`)."""
    rpy = scan["imu_rpy_init"]
    imu_ok = scan["imu_available"] & (torch.abs(rpy[1]) < 1.4)
    w = params.imuRPYWeight

    def slerp_angle(a, b):
        return a + w * torch.atan2(torch.sin(b - a), torch.cos(b - a))

    roll = torch.where(imu_ok, slerp_angle(x6[0], rpy[0]), x6[0])
    pitch = torch.where(imu_ok, slerp_angle(x6[1], rpy[1]), x6[1])
    tol = params.rotation_tollerance
    roll = torch.clamp(roll, -tol, tol)
    pitch = torch.clamp(pitch, -tol, tol)
    z = torch.clamp(x6[5], -params.z_tollerance, params.z_tollerance)
    return torch.stack([roll, pitch, x6[2], x6[3], x6[4], z])


def _is_keyframe(state: LioMapState, params: LioParams, scan_time, is_livox: bool):
    """`saveFrame` (`:1387-1412`)."""
    last = torch.clamp(state.kf_count - 1, min=0).long()
    livox_force = is_livox & (
        (scan_time - state.kf_time[last]) > params.livox_keyframe_interval)
    t1, q1 = _x6_to_tq(state.x6)
    ti, qi = lie.se3_relative(state.kf_trans[last], state.kf_quat[last], t1, q1)
    rpy = torch.abs(lie.matrix_to_ypr(lie.quat_to_matrix(qi)) * (math.pi / 180.0))
    small = (torch.all(rpy < params.keyframeAddingAngleThreshold)
             & (lie.norm3(ti) < params.keyframeAddingDistThreshold))
    return (state.kf_count == 0) | livox_force | (~small)


def _add_keyframe(state: LioMapState, feats: FeatureResult, caps: LioCaps,
                  params: LioParams, scan_time, k: int):
    """`saveKeyFramesAndFactor` without the solve (`:1529-1613`): push
    keyframe k and its odometry factor."""
    dt = state.x6.dtype
    t, q = _x6_to_tq(state.x6)
    c_xyz, c_val, _ = pc.voxel_downsample(
        feats.corner_xyz, feats.corner_valid, params.mappingCornerLeafSize,
        caps.kf_corner)
    s_xyz, s_val, _ = pc.voxel_downsample(
        feats.surf_xyz, feats.surf_valid, params.mappingSurfLeafSize, caps.kf_surf)

    g = state.graph
    if k == 0:
        g = g._replace(prior_trans=t, prior_quat=q,
                       prior_sqrtw=torch.tensor(pg.PRIOR_SQRTW, dtype=dt,
                                                device=t.device))
    else:
        ti, qi = lie.se3_relative(g.trans[k - 1], g.quat[k - 1], t, q)
        f = k - 1
        g = g._replace(
            bf_i=_at(g.bf_i, f, k - 1), bf_j=_at(g.bf_j, f, k),
            bf_trans=_at(g.bf_trans, f, ti), bf_quat=_at(g.bf_quat, f, qi),
            bf_sqrtw=_at(g.bf_sqrtw, f, torch.tensor(pg.ODOM_SQRTW, dtype=dt,
                                                     device=t.device)),
            bf_valid=_at(g.bf_valid, f, True),
        )
    g = g._replace(trans=_at(g.trans, k, t), quat=_at(g.quat, k, q),
                   node_valid=_at(g.node_valid, k, True))

    # first-order propagation of the newest pose's x/y marginal variance
    # (see the JAX module: quadratic growth through the yaw cross term)
    if k == 0:
        yaw_var2, cross2, cov2 = state.yaw_var, state.pose_cov_cross, state.pose_cov_xy
    else:
        step = torch.sqrt(torch.sum((t - state.kf_trans[k - 1]) ** 2))
        yaw_var2 = state.yaw_var + 1e-6
        cross2 = state.pose_cov_cross + step * yaw_var2
        cov2 = (state.pose_cov_xy + 1e-4 + 2.0 * step * state.pose_cov_cross
                + step ** 2 * yaw_var2)
    cov2 = torch.clamp(cov2, max=1e8)
    cross2 = torch.clamp(cross2, max=1e8)
    return state._replace(
        graph=g, pose_cov_xy=cov2, yaw_var=yaw_var2, pose_cov_cross=cross2,
        kf_cov_xy=_at(state.kf_cov_xy, k, cov2),
        kf_yaw_var=_at(state.kf_yaw_var, k, yaw_var2),
        kf_cov_cross=_at(state.kf_cov_cross, k, cross2),
        kf_trans=_at(state.kf_trans, k, t), kf_quat=_at(state.kf_quat, k, q),
        kf_time=_at(state.kf_time, k, scan_time),
        kf_corner=_at(state.kf_corner, k, c_xyz),
        kf_corner_valid=_at(state.kf_corner_valid, k, c_val),
        kf_surf=_at(state.kf_surf, k, s_xyz),
        kf_surf_valid=_at(state.kf_surf_valid, k, s_val),
        kf_count=state.kf_count + 1,
    )


def _claim_new_leaves(occ, pts, valid, leaf):
    """Leaf-voxel dedup for incremental map growth: (occ', new_ok, slot,
    tag); new_ok marks the first point of each not-yet-claimed leaf. Slot
    collisions between distinct leaves resolve by tag overwrite, the last
    write winning as in XLA's in-order scatter."""
    Tl = occ.shape[0]
    c = torch.floor(pts / leaf).to(torch.int32)
    slot = vh._slot(c[:, 0], c[:, 1], c[:, 2], Tl)
    tag = vh._tag(c[:, 0], c[:, 1], c[:, 2])
    key = torch.where(valid, slot * 2048 + tag, torch.full_like(slot, 2 ** 30))
    srt = torch.sort(key, stable=True)
    ks = srt.values
    first_sorted = torch.ones_like(ks, dtype=torch.bool)
    first_sorted[1:] = ks[1:] != ks[:-1]
    first_sorted &= ks < 2 ** 30
    first = torch.zeros_like(first_sorted)
    first[srt.indices] = first_sorted
    tag16 = tag.to(torch.int16)
    new_ok = valid & first & (occ[slot.long()] != tag16)
    occ = scatter_set(occ, torch.where(new_ok, slot, torch.full_like(slot, Tl)), tag16)
    return occ, new_ok, slot, tag


def _append_map_points(map_pts, map_valid, n, pts_w, ok, capacity: int):
    """Append `ok` points at rows [n, n+sum(ok)); overflow drops."""
    pos = n + torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32) - 1
    ok = ok & (pos < capacity)
    dst = torch.where(ok, pos, torch.full_like(pos, capacity))
    map_pts = set_rows(map_pts, dst, torch.where(ok[:, None], pts_w,
                                                 torch.zeros_like(pts_w)))
    map_valid = set_rows(map_valid, dst, True)
    return map_pts, map_valid, n + torch.sum(ok, dtype=torch.int32), dst, ok


def _incremental_centroid_update(map_pts, map_valid, n, accum, cnt, occ,
                                 leaf_row, pts_w, valid, leaf, capacity: int):
    """One feature class of `_incremental_map_update`: claim leaves, append
    first-of-new-leaf points, fold every observation into its leaf's
    running centroid."""
    occ2, new_ok, slot, tag = _claim_new_leaves(occ, pts_w, valid, leaf)
    map_pts, map_valid, n2, dst, kept = _append_map_points(
        map_pts, map_valid, n, pts_w, new_ok, capacity)
    Tl = occ2.shape[0]
    released = set_rows(torch.zeros_like(occ2, dtype=torch.bool),
                        torch.where(new_ok & ~kept, slot, torch.full_like(slot, Tl)),
                        True)
    occ2 = torch.where(released, occ, occ2)
    leaf_row = scatter_set(leaf_row, torch.where(kept, slot, torch.full_like(slot, Tl)),
                           dst)
    row = leaf_row[slot.long()]
    contrib = valid & (occ2[slot.long()] == tag.to(torch.int16)) & (row >= 0)
    row = torch.where(contrib, row, torch.full_like(row, capacity))
    accum = scatter_add(accum, row, torch.where(contrib[:, None], pts_w,
                                                torch.zeros_like(pts_w)))
    cnt = scatter_add(cnt, row, contrib.to(cnt.dtype))
    map_pts = torch.where((cnt > 0)[:, None],
                          accum / torch.clamp(cnt, min=1.0)[:, None], map_pts)
    return map_pts, map_valid, n2, accum, cnt, occ2, leaf_row, dst, kept


def _incremental_map_update(state: LioMapState, caps: LioCaps,
                            params: LioParams, k: int):
    """O(new-points) local-map growth for a non-rebuild keyframe k: fold its
    world-frame cloud into the per-leaf running centroids and insert the
    appended rows into the hashes."""
    t, q = state.kf_trans[k], state.kf_quat[k]
    cw = lie.quat_rotate(q[None, :], state.kf_corner[k]) + t[None, :]
    sw = lie.quat_rotate(q[None, :], state.kf_surf[k]) + t[None, :]
    mc, mc_val, nc, acc_c, cnt_c, occ_c, lr_c, dst_c, ok_c = (
        _incremental_centroid_update(
            state.map_corner, state.map_corner_valid, state.map_corner_n,
            state.map_corner_accum, state.map_corner_cnt,
            state.leaf_occ_corner, state.leaf_row_corner,
            cw, state.kf_corner_valid[k], params.mappingCornerLeafSize,
            caps.map_corner))
    ms, ms_val, ns, acc_s, cnt_s, occ_s, lr_s, dst_s, ok_s = (
        _incremental_centroid_update(
            state.map_surf, state.map_surf_valid, state.map_surf_n,
            state.map_surf_accum, state.map_surf_cnt,
            state.leaf_occ_surf, state.leaf_row_surf,
            sw, state.kf_surf_valid[k], params.mappingSurfLeafSize,
            caps.map_surf))
    return state._replace(
        map_corner=mc, map_corner_valid=mc_val, map_corner_n=nc,
        map_surf=ms, map_surf_valid=ms_val, map_surf_n=ns,
        map_corner_accum=acc_c, map_corner_cnt=cnt_c,
        map_surf_accum=acc_s, map_surf_cnt=cnt_s,
        leaf_occ_corner=occ_c, leaf_occ_surf=occ_s,
        leaf_row_corner=lr_c, leaf_row_surf=lr_s,
        corner_hash=vh.insert(state.corner_hash, cw, ok_c, dst_c),
        surf_hash=vh.insert(state.surf_hash, sw, ok_s, dst_s),
        kf_since_rebuild=state.kf_since_rebuild + 1,
    )


def _full_map_rebuild(state: LioMapState, caps: LioCaps, params: LioParams,
                      scan_time, track_incremental: bool):
    """Re-assemble + re-downsample the local map, rebuild both hashes and
    reset the incremental bookkeeping."""
    mc, mc_val, ms, ms_val = _assemble_local_map(state, caps, params, scan_time)
    state = state._replace(
        map_corner=mc, map_corner_valid=mc_val, map_surf=ms, map_surf_valid=ms_val,
        corner_hash=vh.build(mc, mc_val, 1.0, caps.corner_hash_size, caps.hash_bucket),
        surf_hash=vh.build(ms, ms_val, 1.0, caps.surf_hash_size, caps.surf_hash_bucket),
    )
    if not track_incremental:
        return state
    dev = mc.device

    def leaves(pts, val, leaf, table, capacity):
        occ, ok, slot, _ = _claim_new_leaves(
            torch.full((table,), -1, dtype=torch.int16, device=dev), pts, val, leaf)
        rows = scatter_set(
            torch.full((table,), -1, dtype=torch.int32, device=dev),
            torch.where(ok, slot, torch.full_like(slot, table)),
            torch.arange(capacity, dtype=torch.int32, device=dev))
        return occ, rows

    occ_c, lr_c = leaves(mc, mc_val, params.mappingCornerLeafSize,
                         caps.corner_leaf_table, caps.map_corner)
    occ_s, lr_s = leaves(ms, ms_val, params.mappingSurfLeafSize,
                         caps.surf_leaf_table, caps.map_surf)
    return state._replace(
        map_corner_n=torch.sum(mc_val, dtype=torch.int32),
        map_surf_n=torch.sum(ms_val, dtype=torch.int32),
        kf_since_rebuild=torch.zeros_like(state.kf_since_rebuild),
        leaf_occ_corner=occ_c, leaf_occ_surf=occ_s,
        leaf_row_corner=lr_c, leaf_row_surf=lr_s,
        map_corner_accum=torch.where(mc_val[:, None], mc, torch.zeros_like(mc)),
        map_corner_cnt=mc_val.to(state.map_corner_cnt.dtype),
        map_surf_accum=torch.where(ms_val[:, None], ms, torch.zeros_like(ms)),
        map_surf_cnt=ms_val.to(state.map_surf_cnt.dtype),
    )


def _optimize_graph(state: LioMapState, k: int):
    """Batch solve + pose rewrite when loop/GPS factors are pending
    (`correctPoses`, `:1615-1646`); k is the newest keyframe."""
    g = pg.optimize(state.graph, gn_iters=6, pcg_iters=96)
    keep = g.node_valid[:, None]
    return state._replace(
        graph=g,
        kf_trans=torch.where(keep, g.trans, state.kf_trans),
        kf_quat=torch.where(keep, g.quat, state.kf_quat),
        x6=_tq_to_x6(g.trans[k], g.quat[k]),
        loop_pending=torch.zeros_like(state.loop_pending),
    )


class MapPrologue(NamedTuple):
    """What `map_prologue` hands the GN and `map_epilogue`."""

    incr_front: torch.Tensor  # the pose before the step (x6)
    c_xyz: torch.Tensor  # downsampled corner features
    c_val: torch.Tensor
    s_xyz: torch.Tensor  # downsampled surf features
    s_val: torch.Tensor
    run_gn: bool  # the gate: enough features and a map to match


def map_prologue(state: LioMapState, scan: dict, feats: FeatureResult,
                 caps: LioCaps, params: LioParams):
    """`map_step` up to the GN: the initial guess, the two voxel
    downsamples and the gate (one host read). Returns (state, prologue)."""
    incr_front = state.x6
    state = _update_initial_guess(state, scan, params)

    c_xyz, c_val, _ = pc.voxel_downsample(
        feats.corner_xyz, feats.corner_valid, params.mappingCornerLeafSize,
        caps.scan_corner)
    s_xyz, s_val, _ = pc.voxel_downsample(
        feats.surf_xyz, feats.surf_valid, params.mappingSurfLeafSize, caps.scan_surf)

    enough = (torch.sum(c_val, dtype=torch.int32) > params.edgeFeatureMinValidNum) & (
        torch.sum(s_val, dtype=torch.int32) > params.surfFeatureMinValidNum)
    return state, MapPrologue(incr_front, c_xyz, c_val, s_xyz, s_val,
                              host_bool(enough & (state.kf_count > 0)))


def gn_options(caps: LioCaps, params: LioParams, max_gn_iters: int = 20) -> dict:
    """The keyword arguments of the step's ``scan_to_map_hashed`` call."""
    return dict(max_iters=max_gn_iters, eigen_thresh=params.degeneracyEigenThreshold,
                nn_refresh_every=params.nnRefreshEvery, use_pallas=caps.pallas_knn,
                gather_once=params.gatherOncePerScan and caps.pallas_knn,
                use_pallas_gn=caps.pallas_gn)


def map_gn(state: LioMapState, pro: MapPrologue, caps: LioCaps, params: LioParams,
           max_gn_iters: int = 20) -> scan2map.GNState:
    """`map_step`'s scan-to-map GN, for a prologue whose gate passed."""
    with record_function("lio.scan_to_map"):
        return scan2map.scan_to_map_hashed(
            state.x6, pro.c_xyz, pro.c_val, pro.s_xyz, pro.s_val,
            state.map_corner, state.map_surf, state.corner_hash, state.surf_hash,
            **gn_options(caps, params, max_gn_iters))


def map_step(state: LioMapState, scan: dict, feats: FeatureResult,
             caps: LioCaps, params: LioParams, is_livox: bool = True,
             max_gn_iters: int = 20):
    """One `laserCloudInfoHandler` step (`mapOptimization.cpp:298-332`):
    `map_epilogue(map_gn(map_prologue))`."""
    state, pro = map_prologue(state, scan, feats, caps, params)
    st = map_gn(state, pro, caps, params, max_gn_iters) if pro.run_gn else None
    return map_epilogue(state, pro, st, scan, feats, caps, params, is_livox)


def map_epilogue(state: LioMapState, pro: MapPrologue, st, scan: dict,
                 feats: FeatureResult, caps: LioCaps, params: LioParams,
                 is_livox: bool = True):
    """`map_step` after the GN: the transform update, the odometry chain,
    the keyframe and what it triggers (GPS factor, graph solve, map update).
    `st` is the GN's state, or None where the gate failed."""
    dev = state.x6.device
    if st is not None:
        x6_new, degen, n_res, gn_iters = st.x6, st.degenerate, st.num_residuals, st.it
    else:
        x6_new = state.x6
        degen = torch.zeros((), dtype=torch.bool, device=dev)
        n_res = torch.zeros((), dtype=torch.int32, device=dev)
        gn_iters = torch.zeros((), dtype=torch.int32, device=dev)
    x6_new = _transform_update(scan, params, x6_new)
    state = state._replace(x6=x6_new, degenerate=degen,
                           last_gn_ok=(gn_iters > 0) & (n_res >= 50) & (~degen))

    # incremental odometry: the pure scan-match delta chain
    tf, qf = _x6_to_tq(pro.incr_front)
    tb, qb = _x6_to_tq(x6_new)
    ti, qi = lie.se3_relative(tf, qf, tb, qb)
    tp, qp = _x6_to_tq(state.incr_x6)
    tn, qn = lie.se3_compose(tp, qp, ti, qi)
    incr_x6 = torch.where(state.kf_count == 0, x6_new, _tq_to_x6(tn, qn))
    state = state._replace(incr_x6=incr_x6, last_delta_t=ti, last_delta_q=qi)

    # beyond max_keyframes the map freezes; odometry keeps running
    is_kf = _is_keyframe(state, params, scan["stamp"], is_livox)
    is_kf = is_kf & (state.kf_count < caps.max_keyframes)
    if host_bool(is_kf):
        with record_function("lio.keyframe"):
            k = host_int(state.kf_count)
            state = _add_keyframe(state, feats, caps, params, scan["stamp"], k)
            # GPS factor between keyframe insert and the solve (`:1540-1551`)
            if "gps_available" in scan and host_bool(scan["gps_available"]):
                state = _add_gps_factor_impl(state, scan["gps_pos"], scan["gps_noise"],
                                             scan["gps_use_elevation"], params)
            corrected = host_bool(state.loop_pending)
            if corrected:
                state = _optimize_graph(state, k)
            if params.mapRebuildEvery <= 1:
                state = _full_map_rebuild(state, caps, params, scan["stamp"],
                                          track_incremental=False)
            else:
                force_full = (
                    (state.kf_since_rebuild + 1 >= params.mapRebuildEvery)
                    | (state.map_corner_n + caps.kf_corner > caps.map_corner)
                    | (state.map_surf_n + caps.kf_surf > caps.map_surf)
                )
                if corrected or host_bool(force_full):
                    state = _full_map_rebuild(state, caps, params, scan["stamp"],
                                              track_incremental=True)
                else:
                    state = _incremental_map_update(state, caps, params, k)

    return state, MapOutputs(x6=state.x6, incr_x6=incr_x6, degenerate=degen,
                             is_keyframe=is_kf, num_residuals=n_res,
                             gn_iters=gn_iters)


def _add_gps_factor_impl(state: LioMapState, gps_pos, gps_noise, use_elevation,
                         params: LioParams):
    """`addGPSFactor` (`mapOptimization.cpp:1433-1507`): unary position
    factor on the newest keyframe, behind the reference's gates (see the JAX
    module for each gate)."""
    k = host_int(state.kf_count) - 1
    g = state.graph
    noise = torch.clamp(gps_noise, min=1.0)
    z = torch.where(use_elevation, gps_pos[2], state.kf_trans[k, 2])
    nz = torch.where(use_elevation, noise[2], torch.full_like(noise[2], 0.01))
    pos = torch.cat([gps_pos[:2], z[None]])
    sqrtw = 1.0 / torch.sqrt(torch.cat([noise[:2], nz[None]]))
    ok = ((state.pose_cov_xy >= params.poseCovThreshold) & (state.kf_count > 0)
          & (lie.norm3(state.kf_trans[0] - state.kf_trans[k]) >= 5.0)
          & (gps_noise[0] <= params.gpsCovThreshold)
          & (gps_noise[1] <= params.gpsCovThreshold)
          & ((~state.has_gps) | (lie.norm3(pos - state.last_gps_pos) >= 5.0)))
    slot = torch.argmin(g.up_valid.to(torch.int32))  # first free slot
    if not host_bool(ok & (~g.up_valid[slot])):
        return state
    g2 = g._replace(
        up_k=_at(g.up_k, slot, k), up_pos=_at(g.up_pos, slot, pos),
        up_sqrtw=_at(g.up_sqrtw, slot, sqrtw), up_valid=_at(g.up_valid, slot, True),
    )
    xy_var = torch.maximum(noise[0], noise[1])
    d2 = torch.sum((pos - state.last_gps_pos) ** 2)
    yaw2 = torch.where(state.has_gps,
                       torch.minimum(state.yaw_var,
                                     2.0 * xy_var / torch.clamp(d2, min=1.0)),
                       state.yaw_var)
    return state._replace(
        graph=g2, loop_pending=torch.ones_like(state.loop_pending),
        last_gps_pos=pos, has_gps=torch.ones_like(state.has_gps),
        n_gps=state.n_gps + 1,
        pose_cov_xy=xy_var, yaw_var=yaw2,
        pose_cov_cross=torch.zeros_like(state.pose_cov_cross),
        kf_cov_xy=_at(state.kf_cov_xy, k, xy_var),
        kf_yaw_var=_at(state.kf_yaw_var, k, yaw2),
        kf_cov_cross=_at(state.kf_cov_cross, k, 0.0),
    )


def add_gps_factor(state: LioMapState, gps_pos, gps_noise, use_elevation,
                   caps: LioCaps, params: LioParams):
    """Standalone entry for hosts that apply GPS outside `map_step`."""
    use = torch.as_tensor(use_elevation, device=gps_pos.device)
    return _add_gps_factor_impl(state, gps_pos, gps_noise, use, params)


# ---------------------------------------------------------------------------
# Loop closure (`loopClosureThread`, `mapOptimization.cpp:523-741`)
# ---------------------------------------------------------------------------

class LoopResult(NamedTuple):
    found: torch.Tensor  # () bool
    kf_from: torch.Tensor  # () int
    kf_to: torch.Tensor  # () int
    fitness: torch.Tensor  # ()


def _loop_icp(state: LioMapState, cur, cand, caps: LioCaps, params: LioParams):
    """Submap ICP verification + loop factor insertion for a (cur, cand)
    keyframe pair (`performLoopClosure`, `:549-628`)."""
    K = caps.max_keyframes
    dev = state.x6.device
    cur_t = state.kf_trans[cur]
    src = torch.cat([state.kf_corner[cur], state.kf_surf[cur]], dim=0)
    srcv = torch.cat([state.kf_corner_valid[cur], state.kf_surf_valid[cur]], dim=0)
    src_w = lie.quat_rotate(state.kf_quat[cur][None, :], src) + cur_t[None, :]

    n = params.historyKeyframeSearchNum
    offs = torch.arange(2 * n + 1, device=dev) - n
    sub_idx = torch.clamp(cand + offs, 0, K - 1)
    sub_ok = (sub_idx >= 0) & (sub_idx < state.kf_count)
    t = state.kf_trans[sub_idx]
    q = state.kf_quat[sub_idx]
    # target submap stacks corner + surf clouds (`loopFindNearKeyframes`)
    sub_s = state.kf_surf[sub_idx]
    sub_sv = state.kf_surf_valid[sub_idx] & sub_ok[:, None]
    sub_c = state.kf_corner[sub_idx]
    sub_cv = state.kf_corner_valid[sub_idx] & sub_ok[:, None]
    tgt_s = lie.quat_rotate(q[:, None, :], sub_s) + t[:, None, :]
    tgt_c = lie.quat_rotate(q[:, None, :], sub_c) + t[:, None, :]
    tgt = torch.cat([tgt_c.reshape(-1, 3), tgt_s.reshape(-1, 3)])
    tgtv = torch.cat([sub_cv.reshape(-1), sub_sv.reshape(-1)])
    # on capacity overflow keep the voxels nearest the candidate
    cand_t = state.kf_trans[cand]
    tgt_ds, tgt_val, _ = pc.voxel_downsample(
        tgt, tgtv, params.mappingSurfLeafSize, caps.loop_submap, center=cand_t)
    # source points beyond the kept submap's coverage have no possible
    # correspondence (capacity artifacts): exclude them
    d_tgt = lie.norm3(tgt_ds - cand_t[None, :])
    r_cov = (torch.amax(torch.where(tgt_val, d_tgt, torch.zeros_like(d_tgt)))
             - params.mappingSurfLeafSize)
    srcv = srcv & (lie.norm3(src_w - cand_t[None, :]) <= r_cov)

    res = icp_ops.icp_point2point(
        src_w, srcv, tgt_ds, tgt_val,
        torch.zeros(3, dtype=src.dtype, device=dev), lie.quat_identity(src.dtype, dev),
        max_corr_dist=params.historyKeyframeSearchRadius * 2.0,
        iters=caps.icp_iters,
    )
    good = res.fitness < params.historyKeyframeFitnessScore
    result = LoopResult(found=good, kf_from=cur, kf_to=cand, fitness=res.fitness)
    if not host_bool(good & (state.n_loops < caps.max_loops)):
        return state, result

    # corrected current pose T_corr = ICP ∘ T_cur; factor cur -> cand
    t_cor, q_cor = lie.se3_compose(res.trans, res.quat, cur_t, state.kf_quat[cur])
    ti, qi = lie.se3_relative(t_cor, q_cor, state.kf_trans[cand], state.kf_quat[cand])
    noise = torch.clamp(res.fitness, min=1e-6)
    sqrtw = torch.full((6,), 1.0, dtype=src.dtype, device=dev) / torch.sqrt(noise)
    f = K + state.n_loops  # loop slots follow the K-1 odometry slots
    g = state.graph
    g = g._replace(
        bf_i=_at(g.bf_i, f, cur), bf_j=_at(g.bf_j, f, cand),
        bf_trans=_at(g.bf_trans, f, ti), bf_quat=_at(g.bf_quat, f, qi),
        bf_sqrtw=_at(g.bf_sqrtw, f, sqrtw), bf_valid=_at(g.bf_valid, f, True),
    )
    # the loop re-anchors `cur` to `cand`: the newest pose's marginal
    # collapses to ~the anchor's snapshot + ICP noise + the yaw lever
    yaw_l = torch.minimum(state.yaw_var, state.kf_yaw_var[cand] + noise)
    lever2 = torch.sum(ti ** 2)
    cov_l = torch.minimum(state.pose_cov_xy,
                          state.kf_cov_xy[cand] + noise + lever2 * yaw_l)
    cross_l = torch.minimum(state.pose_cov_cross,
                            state.kf_cov_cross[cand] + torch.sqrt(lever2) * yaw_l)
    state = state._replace(
        graph=g, n_loops=state.n_loops + 1,
        loop_pending=torch.ones_like(state.loop_pending),
        last_loop_kf=cur.to(torch.int32),
        pose_cov_xy=cov_l, yaw_var=yaw_l, pose_cov_cross=cross_l,
        kf_cov_xy=_at(state.kf_cov_xy, cur, cov_l),
        kf_yaw_var=_at(state.kf_yaw_var, cur, yaw_l),
        kf_cov_cross=_at(state.kf_cov_cross, cur, cross_l),
    )
    return state, result


def loop_closure_step(state: LioMapState, caps: LioCaps, params: LioParams):
    """Distance-based candidate search + submap ICP
    (`detectLoopClosureDistance` `:630-663`). Returns (state, LoopResult)."""
    K = caps.max_keyframes
    dev = state.x6.device
    cur = (state.kf_count - 1).long()
    cur_t = state.kf_trans[cur]
    cur_time = state.kf_time[cur]
    old_ok = (torch.arange(K, device=dev) < state.kf_count) & (
        (cur_time - state.kf_time) > params.historyKeyframeSearchTimeDiff)
    d = lie.norm3(state.kf_trans - cur_t[None, :])
    cand_ok = old_ok & (d < params.historyKeyframeSearchRadius)
    cand = torch.argmin(torch.where(cand_ok, d, torch.full_like(d, math.inf)))
    has_cand = torch.any(cand_ok) & (state.kf_count > 1) & (cur != state.last_loop_kf)
    if host_bool(has_cand):
        return _loop_icp(state, cur, cand, caps, params)
    return state, LoopResult(
        found=torch.zeros((), dtype=torch.bool, device=dev), kf_from=cur,
        kf_to=torch.full((), -1, dtype=torch.long, device=dev),
        fitness=torch.full((), math.inf, device=dev))


def loop_closure_external(state: LioMapState, cur, old, caps: LioCaps, params: LioParams):
    """An external (visual) loop candidate, keyframes `cur` -> `old`, through
    the same submap ICP verification (`detectLoopClosureExternal`,
    `mapOptimization.cpp:665-741`). One host read: whether the pair is
    valid. Returns (state, LoopResult)."""
    dev = state.x6.device
    cur = torch.as_tensor(cur, dtype=torch.long, device=dev)
    old = torch.as_tensor(old, dtype=torch.long, device=dev)
    ok = (cur < state.kf_count) & (old >= 0) & (old < state.kf_count) & (cur != old)
    if host_bool(ok):
        return _loop_icp(state, cur, old, caps, params)
    return state, LoopResult(
        found=torch.zeros((), dtype=torch.bool, device=dev), kf_from=cur,
        kf_to=torch.full((), -1, dtype=torch.long, device=dev),
        fitness=torch.full((), math.inf, device=dev))
