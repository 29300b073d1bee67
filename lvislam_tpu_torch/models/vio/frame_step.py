"""One camera frame of the fused LVI system — port of
``lvislam_tpu.models.vio.frame_step`` (`_sizes`, `pack_frame`,
`frame_step`).

The host packs the frame, its IMU window, the vins_world -> vins_body TF,
the ring's 5 s freshness mask and the lidar-seeded init payload into one
int16 buffer (``pack_frame``, byte for byte the JAX package's): one
host-to-device copy a frame. ``frame_step`` unpacks it on the device and
runs the tracker step (CLAHE: kernels K3 and K4 on the card), the lidar
depth registration against the device-resident cloud ring, `process_imu`
and `process_image`, and returns a 21-float summary for the one readback.

JAX's ``lax.cond(imu_n > 0, ...)`` is a host branch on the count the host
packed. The estimator's window fill comes from the caller's host copy
(`frame_count`), as `VioRunner` passes it. The fused replay
(``models/replay.py``) keeps the ring's stamps and the vins_world ->
vins_body TF on the device: ``frame_step``'s `depth_stamps` and
`body_override` replace the packed freshness mask and TF.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ...core.config import CameraIntrinsics
from ...ops import ba
from . import estimator as est
from . import feature_manager as fm
from . import feature_tracker as ft

_MISC = 12  # t, imu_n, depth_on, body_trans(3), body_quat(4), seed_avail


def _sizes(caps: fm.VioCaps, H: int, W: int, slots: int):
    assert (H * W) % 2 == 0
    M = caps.imu_buf
    W1 = caps.window + 1
    nf = M * 7 + _MISC + slots + W1 * 10 + 6
    return M, W1, nf, H * W // 2 + nf * 2


def pack_frame(
    caps: fm.VioCaps,
    img: np.ndarray,  # (H, W) uint8, or float in [0, 1] (quantized here)
    t: float,
    imu_dts: np.ndarray, imu_accs: np.ndarray, imu_gyrs: np.ndarray,
    imu_n: int,
    depth_fresh: np.ndarray,  # (S,) bool — ring slots younger than 5 s
    body_trans, body_quat,  # vins_world -> vins_body TF (or None)
    seed: dict | None,  # lidar-seeded init payload (numpy) or None
) -> np.ndarray:
    """The frame's one upload: the image as bytes, then float32 fields
    bit-cast into int16 (layout of the JAX package's ``pack_frame``)."""
    H, W = img.shape
    S = len(depth_fresh)
    M, W1, nf, L = _sizes(caps, H, W, S)
    buf = np.zeros(L, np.int16)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    buf[: H * W // 2] = img.reshape(-1).view(np.int16)
    f = buf[H * W // 2:].view(np.float32)
    imu = f[: M * 7].reshape(M, 7)
    n = min(int(imu_n), M)
    if n > 0:
        imu[:n, 0] = imu_dts[:n]
        imu[:n, 1:4] = imu_accs[:n]
        imu[:n, 4:7] = imu_gyrs[:n]
        imu[n:, 1:4] = imu[max(n - 1, 0), 1:4]
        imu[n:, 4:7] = imu[max(n - 1, 0), 4:7]
    misc = f[M * 7: M * 7 + _MISC]
    misc[0] = t
    misc[1] = n
    misc[2] = float(body_trans is not None)
    if body_trans is not None:
        misc[3:6] = body_trans
        misc[6:10] = body_quat
    else:
        misc[6] = 1.0
    misc[10] = float(seed is not None)
    f[M * 7 + _MISC: M * 7 + _MISC + S] = depth_fresh.astype(np.float32)
    if seed is not None:
        sd = f[M * 7 + _MISC + S:]
        sd[: W1 * 3] = np.asarray(seed["Ps"], np.float32).reshape(-1)
        sd[W1 * 3: W1 * 7] = np.asarray(seed["Qs"], np.float32).reshape(-1)
        sd[W1 * 7: W1 * 10] = np.asarray(seed["Vs"], np.float32).reshape(-1)
        sd[W1 * 10: W1 * 10 + 3] = np.asarray(seed["ba"], np.float32)
        sd[W1 * 10 + 3:] = np.asarray(seed["bg"], np.float32)
    return buf


def _unpack_image(buf: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return buf[: H * W // 2].view(torch.uint8).reshape(H, W).to(torch.float32) * (1.0 / 255.0)


def _unpack_seed(sd: torch.Tensor, W1: int, available: bool) -> dict:
    return dict(
        available=available,
        Ps=sd[: W1 * 3].reshape(W1, 3),
        Qs=sd[W1 * 3: W1 * 7].reshape(W1, 4),
        Vs=sd[W1 * 7: W1 * 10].reshape(W1, 3),
        ba=sd[W1 * 10: W1 * 10 + 3],
        bg=sd[W1 * 10 + 3: W1 * 10 + 6],
    )


def _track(tracker, img, t, fresh, body_avail, body_trans, body_quat,
           depth_clouds, depth_valid, tparams, cam, use_depth, sampler):
    """The tracker step (CLAHE + LK + F-RANSAC + refill) and the lidar
    depth channel (exchange 2): (tracker', tout, depth)."""
    with record_function("vio.tracker"):
        tracker2, tout = ft.tracker_step(tracker, img, t, tparams, cam, sampler=sampler)
    depth = torch.full((tparams.max_cnt,), -1.0, dtype=torch.float32, device=img.device)
    if use_depth:
        with record_function("vio.depth"):
            S = depth_clouds.shape[0]
            depth_on = body_avail & torch.any(fresh)
            d = ft.register_depth(
                tout.norm, tout.valid,
                depth_clouds.reshape(S * depth_clouds.shape[1], 3),
                (depth_valid & fresh[:, None]).reshape(-1),
                body_trans, body_quat,
            )
            depth = torch.where(depth_on, d, depth)
    return tracker2, tout, depth


def _estimate(vio, imu, ids, norm, vel, depth, valid, rt, n_tracked, seed,
              caps, vparams, cfg, frame_count, imu_n, sampler):
    """Inter-frame IMU preintegration (the window already td-aligned by the
    host; an empty window, first frame or stream gap, preintegrates
    nothing) and the estimator step: (vio', summary (21,), frame_count')."""
    M = caps.imu_buf
    if imu_n > 0:
        with record_function("vio.preint"):
            dts = torch.where(torch.arange(M, device=imu.device) < imu_n, imu[:, 0], 0.0)
            vio = est.process_imu(vio, dts, imu[:, 1:4], imu[:, 4:7], caps, vparams,
                                  frame_count=frame_count)
    with record_function("vio.estimator"):
        vio3, vout = est.process_image(
            vio, ids, norm, vel, depth, valid, seed, caps, vparams, cfg, rt=rt,
            frame_count=frame_count, sampler=sampler,
        )
    fc = vout["frame_count"]
    j = min(fc, caps.window)
    f32 = lambda x: x.to(torch.float32)[None]
    summary = torch.cat([
        vout["pos"], vout["quat"], vout["vel"],
        vio3.ws.Bas[j], vio3.ws.Bgs[j],
        vio3.ws.td[None],
        f32(vout["initialized"]), f32(vout["is_keyframe"]),
        f32(vio3.failure_count), f32(n_tracked),
    ])
    return vio3, summary, fc


def frame_step(
    tracker: ft.TrackerState,
    vio: est.VioState,
    buf: torch.Tensor,  # (L,) int16 from pack_frame, on the device
    depth_clouds: torch.Tensor,  # (S, P, 3) device-resident ring (VINS world)
    depth_valid: torch.Tensor,  # (S, P) bool
    tparams: ft.TrackerParams,
    cam: CameraIntrinsics,
    caps: fm.VioCaps,
    vparams: est.VioParams,
    cfg: ba.BAConfig,
    height: int,
    width: int,
    use_depth: bool = True,
    rolling_shutter_tr: float = 0.0,
    *,
    frame_count: int,  # the caller's host copy of vio.frame_count
    imu_n: int,  # the IMU count the host packed
    seed_available: bool,  # whether the host packed a seed
    sampler: ft.Sampler | None = None,  # RANSAC draws (tracker, estimator)
    depth_stamps: torch.Tensor | None = None,  # (S,) ring stamps on the device:
    # the 5 s freshness mask is computed here instead of packed
    body_override=None,  # (avail, trans(3), quat(4)) on the device, replacing
    # the packed vins_world -> vins_body TF
):
    """Returns (tracker', vio', tout, depth, summary (21,) f32, frame_count'):
    summary = [pos(3), quat(4), vel(3), ba(3), bg(3), td, initialized,
    is_keyframe, failure_count, n_tracked]; frame_count' is the host count
    to pass with the next frame."""
    H, W = height, width
    S = depth_clouds.shape[0]
    M, W1, nf, L = _sizes(caps, H, W, S)
    f = buf[H * W // 2:].view(torch.float32)
    misc = f[M * 7: M * 7 + _MISC]
    fresh = f[M * 7 + _MISC: M * 7 + _MISC + S] > 0.5
    if depth_stamps is not None:
        fresh = depth_stamps > misc[0] - 5.0
    body = (misc[2] > 0.5, misc[3:6], misc[6:10]) if body_override is None else body_override
    tracker2, tout, depth = _track(
        tracker, _unpack_image(buf, H, W), misc[0], fresh, *body,
        depth_clouds, depth_valid, tparams, cam, use_depth, sampler)
    rt = None
    if rolling_shutter_tr > 0:
        rt = tout.uv[:, 1] * (rolling_shutter_tr / H)
    vio3, summary, fc = _estimate(
        vio, f[: M * 7].reshape(M, 7), tout.ids, tout.norm, tout.vel, depth, tout.valid,
        rt, tout.n_tracked, _unpack_seed(f[M * 7 + _MISC + S:], W1, seed_available),
        caps, vparams, cfg, frame_count, imu_n, sampler)
    return tracker2, vio3, tout, depth, summary, fc

