"""The batched fused replay of the LVI system — port of
``lvislam_tpu.models.replay``: K sensor events staged on the host, shipped
as one upload, run on the device one after another, read back once.

The interactive ``LviSystem`` path reads a summary back after every scan
and every frame, and exchanges 1, 2 and 4 go through the host. Here the
cross-subsystem feedback stays on the device, so whole batches of events
need one upload and one deferred readback:

- exchange 1 (VIS -> LIS initial guess): the estimator's nav state lives in
  the carry and is dead-reckoned to the exact scan stamp with the scan's own
  IMU window (`estimator_node.cpp:218-245`, the reference's IMU-rate
  `imu_propagate`, propagated on demand inside the scan event);
- exchange 2 (LIS -> VIS depth): the deskewed-cloud ring, its stamps and
  the 5 s freshness mask are device state (`feature_tracker_node.cpp:
  273-377`);
- exchange 4 (VIS -> LIS loop): BRIEF / BoW detection, PnP verification,
  the stamp -> keyframe mapping (``argmin`` over `kf_time` on the device)
  and the ICP loop application run in the frame event
  (`loop_detector.cpp:12-150` -> `mapOptimization.cpp:665-741`);
- exchange 5 (failure / reset): the failure counter rides the carry as the
  guess reset id, as on the interactive path.

Each staged event is a fixed-shape int16 row: a lidar scan (the
``pack_scan`` buffer + the guess and glue IMU windows), a camera frame (the
``pack_frame`` buffer), or a no-op pad; the packers are byte for byte the
JAX package's. ``replay_batch_step`` runs the rows in order. Where JAX
switches on the row's kind on the device (``lax.switch``), the port takes
the branch from the host's copy of the row's header: the host packed the
kinds, so choosing a branch reads nothing back. The same host copy gives
the counts the ported steps take as host arguments (the glue window's and
the frame's IMU counts, the seed flag); the carry holds the host copy of
the VIO window fill (`frame_count`). The host reads left are those of the
ported steps themselves (the LIO step's, ``frame_step``'s,
``add_and_detect``'s), the loop gate (initialized and keyframe) and the two
tests of the loop application, which the interactive ``_loop_detect``
reads too. The smoother's initialized flag, a host copy on the interactive
path, is device state inside a batch: both the initialization and the
correction run, and ``torch.where`` takes the one JAX's ``lax.cond`` takes.

Two documented deviations from the interactive path (as in the JAX
package, whose ``tests/test_lvi_replay.py`` bounds them):

- the td used to bound the host-packed frame IMU windows refreshes once per
  batch readback instead of once per frame;
- the depth-cloud ring stores clouds at the guess propagated to the scan
  stamp instead of the last camera-frame pose, closer to the reference,
  which looks up the TF at cloud time (`feature_tracker_node.cpp:300`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core.config import CameraIntrinsics
from ..core.hostsync import host_bool
from ..ops import ba, preintegration as pre
from .lio import imu_fusion as fus
from .lio import mapping
from .lio import pipeline as lp
from .loop import loop_detector as ld
from .vio import estimator as est
from .vio import feature_manager as fm
from .vio import feature_tracker as ft
from .vio import frame_step as fs

KIND_SCAN, KIND_FRAME, KIND_NOOP = 0, 1, 2
GUESS_CAP = 64  # IMU samples for the exchange-1 guess propagation
GLUE_CAP = 64  # IMU samples for the fusion-glue window (`_scan_glue`)
_HDR = 8  # int16 header = 4 f32: [kind, do_depth, pad, pad]
_AUX_F32 = 2 * (1 + GUESS_CAP * 7)  # guess + glue windows
_SCAN_OUT = 26  # `_scan_glue` summary
_FRAME_OUT = 21  # `frame_step` summary
OUT_LEN = 1 + _SCAN_OUT + _FRAME_OUT  # [kind, scan26, frame21]


@dataclasses.dataclass(frozen=True)
class ReplayStatics:
    """Everything the fused event program takes from `LviConfig`, in one
    hashable bundle."""

    lio_caps: mapping.LioCaps
    lio_params: mapping.LioParams
    n_scan: int
    horizon: int
    point_capacity: int
    imu_capacity: int
    min_range: float
    max_range: float
    edge_threshold: float
    surf_threshold: float
    surf_leaf: float
    exact_selection: bool
    fusion: fus.FusionParams
    tracker: ft.TrackerParams
    cam: CameraIntrinsics
    vio_caps: fm.VioCaps
    vio_params: est.VioParams
    ba_cfg: ba.BAConfig
    loop_caps: ld.LoopCaps
    height: int
    width: int
    use_depth: bool
    use_loop: bool
    rolling_shutter_tr: float
    depth_slots: int
    depth_points: int

    @property
    def scan_len(self) -> int:
        return self.point_capacity * 6 + self.imu_capacity * 8 + 48

    @property
    def frame_len(self) -> int:
        return fs._sizes(self.vio_caps, self.height, self.width, self.depth_slots)[3]

    @property
    def row_len(self) -> int:
        return _HDR + max(self.scan_len + 2 * _AUX_F32, self.frame_len)

    @property
    def depth_n(self) -> int:
        """Points copied per accumulated cloud (`_accumulate_depth_cloud`)."""
        return min(self.lio_caps.kf_surf, self.depth_points)

    def lio_kw(self) -> dict:
        """The keywords of ``lio_full_step``."""
        return dict(
            n_scan=self.n_scan, horizon=self.horizon, min_range=self.min_range,
            max_range=self.max_range, edge_threshold=self.edge_threshold,
            surf_threshold=self.surf_threshold, surf_leaf=self.surf_leaf, caps=self.lio_caps,
            params=self.lio_params, point_capacity=self.point_capacity,
            imu_capacity=self.imu_capacity, exact_selection=self.exact_selection)


def statics_from(cfg) -> ReplayStatics:
    """The static bundle of an `LviConfig` (``models/pipeline.py``)."""
    lio = cfg.lio
    return ReplayStatics(
        lio_caps=lio.caps, lio_params=lio.params,
        n_scan=lio.n_scan, horizon=lio.horizon,
        point_capacity=lio.point_capacity, imu_capacity=lio.imu_capacity,
        min_range=lio.min_range, max_range=lio.max_range,
        edge_threshold=lio.edge_threshold, surf_threshold=lio.surf_threshold,
        surf_leaf=lio.odometry_surf_leaf,
        exact_selection=lio.exact_loam_selection,
        fusion=cfg.fusion, tracker=cfg.tracker, cam=cfg.camera,
        vio_caps=cfg.vio_caps, vio_params=cfg.vio_params, ba_cfg=cfg.ba,
        loop_caps=cfg.loop_caps,
        height=cfg.image_height, width=cfg.image_width,
        use_depth=cfg.use_lidar_depth, use_loop=cfg.use_loop_detector,
        rolling_shutter_tr=cfg.rolling_shutter_tr,
        depth_slots=cfg.depth_cloud_slots, depth_points=cfg.depth_cloud_points,
    )


class ReplayCarry(NamedTuple):
    """The whole fused system on the device, and the host copy of the VIO
    window fill that ``frame_step`` takes."""

    lio: mapping.LioMapState
    fusion: fus.FusionState
    tracker: ft.TrackerState
    vio: est.VioState
    loop_db: ld.LoopDB
    depth_clouds: torch.Tensor  # (S, P, 3) VINS-world cloud ring
    depth_valid: torch.Tensor  # (S, P)
    depth_stamps: torch.Tensor  # (S,) f32
    depth_slot: torch.Tensor  # () int32
    # VIS nav state for exchanges 1 and 2:
    # [stamp, pos(3), quat(4), vel(3), ba(3), bg(3), reset_id, valid]
    vins: torch.Tensor  # (19,)
    frame_count: int  # host copy of vio.frame_count


# ------------------------------------------------------------------ packing

def pack_scan_event(
    st: ReplayStatics,
    scan_buf: np.ndarray,  # from lio.pipeline.pack_scan (odom fields unused)
    do_depth: bool,
    guess: tuple,  # (dts, accs, gyrs, n) window (last frame stamp, t_scan]
    glue: tuple,  # (dts, accs, gyrs, n) window (last scan stamp, t_scan]
) -> np.ndarray:
    row = np.zeros(st.row_len, np.int16)
    hdr = np.array([KIND_SCAN, float(do_depth), 0.0, 0.0], np.float32)
    row[:_HDR] = hdr.view(np.int16)
    row[_HDR: _HDR + st.scan_len] = scan_buf
    aux = np.zeros(_AUX_F32, np.float32)
    for k, (dts, accs, gyrs, n) in enumerate((guess, glue)):
        w = aux[k * (1 + GUESS_CAP * 7): (k + 1) * (1 + GUESS_CAP * 7)]
        n = min(int(n), GUESS_CAP)
        w[0] = n
        wi = w[1:].reshape(GUESS_CAP, 7)
        if n > 0:
            wi[:n, 0] = dts[:n]
            wi[:n, 1:4] = accs[:n]
            wi[:n, 4:7] = gyrs[:n]
            wi[n:, 1:4] = wi[max(n - 1, 0), 1:4]
            wi[n:, 4:7] = wi[max(n - 1, 0), 4:7]
    a0 = _HDR + st.scan_len
    row[a0: a0 + 2 * _AUX_F32] = aux.view(np.int16)
    return row


def pack_frame_event(st: ReplayStatics, frame_buf: np.ndarray) -> np.ndarray:
    row = np.zeros(st.row_len, np.int16)
    hdr = np.array([KIND_FRAME, 0.0, 0.0, 0.0], np.float32)
    row[:_HDR] = hdr.view(np.int16)
    row[_HDR: _HDR + st.frame_len] = frame_buf
    return row


def pack_noop_event(st: ReplayStatics) -> np.ndarray:
    row = np.zeros(st.row_len, np.int16)
    hdr = np.array([KIND_NOOP, 0.0, 0.0, 0.0], np.float32)
    row[:_HDR] = hdr.view(np.int16)
    return row


# -------------------------------------------------------------- device step

def _host_row(row: torch.Tensor, hrow: np.ndarray | None) -> np.ndarray:
    """The host copy of a row: `hrow`, or the row itself when it lies on
    the CPU. A row on the card needs its host copy (nothing is read back)."""
    if hrow is not None:
        return hrow
    if row.device.type != "cpu":
        raise ValueError("a row on the device needs its host copy (host_rows)")
    return row.numpy()


def _unpack_window(aux: torch.Tensor):
    n = aux[0].to(torch.int32)
    w = aux[1:].reshape(GUESS_CAP, 7)
    dts = torch.where(torch.arange(GUESS_CAP, device=aux.device) < n, w[:, 0], 0.0)
    return n, dts, w[:, 1:4], w[:, 4:7]


def _scan_branch(carry: ReplayCarry, row: torch.Tensor, st: ReplayStatics,
                 hrow: np.ndarray | None = None):
    """A scan event: the guess dead-reckoned on the device, the LIO step
    with it as the odom override, the fusion glue, the ring write masked by
    ``do_depth & odom_avail``. Returns (carry', (OUT_LEN,) outputs)."""
    from . import pipeline as lvip  # late import: pipeline imports this module

    hrow = _host_row(row, hrow)
    scan_pk = row[_HDR: _HDR + st.scan_len]
    a0 = _HDR + st.scan_len
    aux = row[a0: a0 + 2 * _AUX_F32].view(torch.float32)
    _, gdts, gaccs, ggyrs = _unpack_window(aux[: 1 + GUESS_CAP * 7])
    glue_buf = aux[1 + GUESS_CAP * 7:]
    hdr_h = hrow[:_HDR].view(np.float32)
    glue_n = int(hrow[a0: a0 + 2 * _AUX_F32].view(np.float32)[1 + GUESS_CAP * 7])

    # scan stamp from the packed misc block (the layout of `pack_scan`)
    P, M = st.point_capacity, st.imu_capacity
    stamp = scan_pk[P * 6 + M * 8:].view(torch.float32)[5]

    # exchange 1: the VIS nav state propagated to the scan stamp (dt == 0
    # padding rows are no-ops)
    vins = carry.vins
    G = torch.tensor([0.0, 0.0, -st.fusion.imuGravity], dtype=torch.float32,
                     device=vins.device)
    nav0 = pre.NavState(pos=vins[1:4], quat=vins[4:8], vel=vins[8:11], ba=vins[11:14],
                        bg=vins[14:17])
    nav = pre.navstate_predict(nav0, gdts, gaccs, ggyrs, G)
    odom_avail = (vins[18] > 0.5) & torch.all(torch.isfinite(vins[1:8]))
    override = (odom_avail, nav.pos, nav.quat, vins[17].to(torch.int32))

    lio2, out = lp.lio_full_step(carry.lio, scan_pk, override, **st.lio_kw())
    fusion2, summary = lvip._scan_glue(
        carry.fusion, out.x6, out.incr_x6, out.degenerate, lio2.kf_count, glue_buf,
        st.fusion, initialized=None, n=glue_n)

    # exchange 2: the deskewed cloud into the device ring at slot % S, only
    # where the guess is available (an index on the device, no host read)
    dc, dv, ds, slot = carry.depth_clouds, carry.depth_valid, carry.depth_stamps, carry.depth_slot
    if hdr_h[1] > 0.5:  # do_depth, packed by the host
        n = st.depth_n
        kf = torch.clamp(lio2.kf_count - 1, min=0).long().reshape(1)
        pts_l = lio2.kf_surf.index_select(0, kf)[0, :n]
        pv = lio2.kf_surf_valid.index_select(0, kf)[0, :n]
        pts_w = lie.quat_rotate(nav.quat[None], pts_l) + nav.pos[None]
        k = (slot.long() % st.depth_slots).reshape(1)
        old_c, old_v = dc.index_select(0, k), dv.index_select(0, k)
        new_c, new_v = old_c.clone(), old_v.clone()
        new_c[0, :n] = pts_w
        new_v[0, :n] = pv
        dc = dc.index_copy(0, k, torch.where(odom_avail, new_c, old_c))
        dv = dv.index_copy(0, k, torch.where(odom_avail, new_v, old_v))
        ds = ds.index_copy(0, k, torch.where(odom_avail, stamp, ds.index_select(0, k)))
        slot = slot + odom_avail.to(slot.dtype)

    out_vec = summary.new_zeros(OUT_LEN)
    out_vec[0] = KIND_SCAN
    out_vec[1: 1 + _SCAN_OUT] = summary
    carry2 = carry._replace(lio=lio2, fusion=fusion2, depth_clouds=dc, depth_valid=dv,
                            depth_stamps=ds, depth_slot=slot)
    return carry2, out_vec


def _loop_points(vio: est.VioState, tout: ft.TrackerOutput):
    """Triangulated world points of the tracked features (the payload the
    pose_graph keyframe carries, `pose_graph_node.cpp:123-267`): each
    feature's table row found by id equality (exact integers), anchored at
    its start frame. Shared by this frame event and `LviSystem._loop_detect`."""
    tab = vio.table
    eq = (tab.ids[:, None] == tout.ids[None, :]) & (tab.ids >= 0)[:, None]
    slot_of = torch.argmax(eq.to(torch.uint8), dim=0)  # first match
    has = torch.any(eq, dim=0)
    inv = tab.inv_depth[slot_of]
    sf = tab.start_frame[slot_of].long()
    # gather each matched feature's table row before indexing its start
    # frame (the table's slots can differ from the tracker's)
    obs0 = torch.take_along_dim(tab.obs[slot_of], sf[:, None, None].expand(-1, 1, 2),
                                dim=1)[:, 0]
    depth0 = 1.0 / torch.clamp(inv, min=1e-6)
    pts_c = torch.cat([obs0, torch.ones_like(obs0[:, :1])], -1) * depth0[:, None]
    ws = vio.ws
    pts_imu = lie.quat_rotate(ws.qic[None], pts_c) + ws.tic[None]
    pts_w = lie.quat_rotate(ws.Qs[sf], pts_imu) + ws.Ps[sf]
    pvalid = tout.valid & has & (inv > 0)
    return pts_w, pvalid


def _frame_branch(carry: ReplayCarry, row: torch.Tensor, st: ReplayStatics,
                  hrow: np.ndarray | None = None, sampler=None):
    """A frame event: ``frame_step`` with the ring's stamps and the carried
    TF, the `vins` update on the device, and on an initialized keyframe the
    loop detection with its LIS application. Returns (carry', outputs)."""
    hrow = _host_row(row, hrow)
    H, W = st.height, st.width
    M = st.vio_caps.imu_buf
    fbuf = row[_HDR: _HDR + st.frame_len]
    f_h = hrow[_HDR + H * W // 2: _HDR + st.frame_len].view(np.float32)
    vins = carry.vins
    body_avail = (vins[18] > 0.5) & torch.all(torch.isfinite(vins[1:8]))

    tracker2, vio2, tout, depth, summary, fc = fs.frame_step(
        carry.tracker, carry.vio, fbuf, carry.depth_clouds, carry.depth_valid,
        st.tracker, st.cam, st.vio_caps, st.vio_params, st.ba_cfg, st.height, st.width,
        use_depth=st.use_depth, rolling_shutter_tr=st.rolling_shutter_tr,
        frame_count=carry.frame_count, imu_n=int(f_h[M * 7 + 1]),
        seed_available=bool(f_h[M * 7 + 10] > 0.5), sampler=sampler,
        depth_stamps=carry.depth_stamps, body_override=(body_avail, vins[1:4], vins[4:8]))
    t = fbuf[H * W // 2:].view(torch.float32)[M * 7]  # the frame stamp (misc[0])

    initialized = summary[17] > 0.5
    new_vins = torch.cat([t[None], summary[0:16], summary[19:20], torch.ones_like(t)[None]])
    vins2 = torch.where(initialized, new_vins, vins)

    # exchange 4: visual loop detection and its application to the LIS
    loop_db, lio = carry.loop_db, carry.lio
    if st.use_loop and host_bool(initialized & (summary[18] > 0.5)):
        img = fs._unpack_image(fbuf, H, W)
        pts_w, pvalid = _loop_points(vio2, tout)
        loop_db, cand = ld.add_and_detect(
            loop_db, img, tout.uv, tout.norm, pts_w, pvalid, t, st.loop_caps,
            focal=float(st.cam.gamma1),
            center=torch.tensor([st.cam.u0, st.cam.v0], dtype=torch.float32, device=t.device),
            sampler=sampler)
        if host_bool(cand.found):
            # the loop's stamps -> LIS keyframes by argmin over kf_time
            t_old = loop_db.stamps[cand.old_index.long()]
            K = lio.kf_time.shape[0]
            kvalid = torch.arange(K, device=t.device) < lio.kf_count
            inf = lio.kf_time.new_full((), float("inf"))
            cur = torch.argmin(torch.where(kvalid, torch.abs(lio.kf_time - t), inf))
            old = torch.argmin(torch.where(kvalid, torch.abs(lio.kf_time - t_old), inf))
            if host_bool((lio.kf_count >= 2) & (torch.abs(cur - old) >= 2)):
                lio = mapping.loop_closure_external(lio, cur, old, st.lio_caps,
                                                    st.lio_params)[0]

    out_vec = summary.new_zeros(OUT_LEN)
    out_vec[0] = KIND_FRAME
    out_vec[1 + _SCAN_OUT:] = summary
    carry2 = carry._replace(tracker=tracker2, vio=vio2, loop_db=loop_db, lio=lio, vins=vins2,
                            frame_count=fc)
    return carry2, out_vec


def _noop_branch(carry: ReplayCarry, row: torch.Tensor, st: ReplayStatics,
                 hrow: np.ndarray | None = None):
    out = torch.zeros(OUT_LEN, dtype=torch.float32, device=row.device)
    out[0] = KIND_NOOP
    return carry, out


def replay_batch_step(carry: ReplayCarry, rows: torch.Tensor, st: ReplayStatics,
                      host_rows: np.ndarray | None = None, sampler=None):
    """The staged (K, row_len) int16 rows on the device, in order, each
    through the branch of its kind (taken from `host_rows`, the host copy
    the rows were uploaded from; default: the rows themselves on the CPU).
    `sampler` sets the RANSAC draws of the frame events. Returns (carry',
    (K, OUT_LEN) f32 outputs, left on the device)."""
    if host_rows is None:
        host_rows = _host_row(rows, None)
    outs = []
    for k in range(rows.shape[0]):
        kind = int(np.clip(host_rows[k, :_HDR].view(np.float32)[0], 0, 2))
        if kind == KIND_SCAN:
            carry, o = _scan_branch(carry, rows[k], st, host_rows[k])
        elif kind == KIND_FRAME:
            carry, o = _frame_branch(carry, rows[k], st, host_rows[k], sampler=sampler)
        else:
            carry, o = _noop_branch(carry, rows[k], st, host_rows[k])
        outs.append(o)
    return carry, torch.stack(outs)
