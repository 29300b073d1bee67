"""Carry state across from the JAX package.

Turns a JAX ``SystemConfig``, ``LioMapState`` (any NamedTuple or dataclass
tree whose leaves go through ``np.asarray``), ``LioCaps``, ``LioParams``,
``LioConfig``,
``CameraIntrinsics``, ``TrackerParams``, ``TrackerState``, and the IMU and
VIO side's ``FusionState``, ``PreintState``, ``WindowState``, ``Prior``,
``FeatureTable``, ``VioState``, the loop detector's ``LoopCaps`` and
``LoopDB``, the fused system's ``LviConfig`` and ``LviSystem`` (one whose
batched replay is active too), the replay's
``ReplayStatics`` and ``ReplayCarry``, batched LIO states (a leading B
axis, on one device or over a mesh's ``batch`` slots), the
calibration tool's ``CalibResult``, the ``PoseGraph`` that
``dense_information`` reads, the message dataclasses of ``core/messages``,
and their parameter dataclasses into the port's objects on a given device,
so both implementations can start from one state. Works on the objects' field names
only; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import config as sc
from ..core import messages as msg
from ..core.config import CameraIntrinsics
from ..models import pipeline as lvi
from ..models import replay as rp
from ..models.lio import imu_fusion, mapping, pipeline
from ..models.loop import loop_detector as ld
from ..models.vio import estimator as est
from ..models.vio import feature_manager as fm
from ..models.vio import feature_tracker as ft
from ..ops import ba
from ..ops import calibration as cal
from ..ops import posegraph as pg
from ..ops import preintegration as pre
from ..ops import voxel_hash as vh

_NESTED = {"graph": pg.PoseGraph, "corner_hash": vh.VoxelHash,
           "surf_hash": vh.VoxelHash, "ws": ba.WindowState, "ws_bar": ba.WindowState,
           "table": fm.FeatureTable, "pints": pre.PreintState, "prior": ba.Prior}


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True)).to(device)


def _tree(cls, src, device):
    fields = {}
    for name in cls._fields:
        v = getattr(src, name)
        sub = _NESTED.get(name)
        if sub:
            fields[name] = _tree(sub, v, device)
        elif isinstance(v, tuple):  # a tuple of arrays (the raw IMU buffers)
            fields[name] = tuple(_tensor(x, device) for x in v)
        else:
            fields[name] = _tensor(v, device)
    return cls(**fields)


def state_from_jax(jstate, device=None) -> mapping.LioMapState:
    """A JAX ``LioMapState`` -> the port's ``LioMapState`` on `device`."""
    return _tree(mapping.LioMapState, jstate, device)


def batched_state_from_jax(jstate, device=None, mesh=None) -> mapping.LioMapState:
    """A JAX batched ``LioMapState`` (every leaf with a leading B axis, as
    ``parallel.batch_replay`` makes it) -> the port's on `device`, or with
    `mesh` sharded over its ``batch`` slots."""
    if mesh is None:
        return state_from_jax(jstate, device)
    from ..parallel import mesh as pmesh

    return pmesh.put_tree(state_from_jax(jstate, "cpu"), mesh, pmesh.batch_sharding(mesh))


def to_numpy(tree) -> dict:
    """Flatten a port NamedTuple tree to {"a.b": numpy array}."""
    out = {}
    for name in tree._fields:
        v = getattr(tree, name)
        if hasattr(v, "_fields"):
            out.update({f"{name}.{k}": a for k, a in to_numpy(v).items()})
        elif isinstance(v, tuple):
            out.update({f"{name}.{i}": a.detach().cpu().numpy() for i, a in enumerate(v)})
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def _dc(cls, src, **override):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {n: getattr(src, n) for n in names if hasattr(src, n)}
    kw.update(override)
    return cls(**kw)


def caps_from_jax(jcaps) -> mapping.LioCaps:
    return _dc(mapping.LioCaps, jcaps)


def params_from_jax(jparams) -> mapping.LioParams:
    return _dc(mapping.LioParams, jparams)


def config_from_jax(jcfg) -> pipeline.LioConfig:
    return _dc(pipeline.LioConfig, jcfg, caps=caps_from_jax(jcfg.caps),
               params=params_from_jax(jcfg.params))


def camera_from_jax(jcam) -> CameraIntrinsics:
    return _dc(CameraIntrinsics, jcam)


def system_config_from_jax(jcfg) -> sc.SystemConfig:
    """A JAX ``SystemConfig`` (``core/config.py``: lidar, VINS with its
    camera, capacities) -> the port's."""
    vins = _dc(sc.VinsConfig, jcfg.vins, camera=camera_from_jax(jcfg.vins.camera))
    return _dc(sc.SystemConfig, jcfg, lidar=_dc(sc.LidarConfig, jcfg.lidar), vins=vins,
               caps=_dc(sc.Capacities, jcfg.caps))


def tracker_params_from_jax(jparams) -> ft.TrackerParams:
    return _dc(ft.TrackerParams, jparams)


def tracker_state_from_jax(jstate, device=None) -> ft.TrackerState:
    """A JAX ``TrackerState`` (its ``prev_pyr`` tuple included) -> the
    port's ``TrackerState`` on `device`."""
    fields = {name: _tensor(getattr(jstate, name), device)
              for name in ft.TrackerState._fields if name != "prev_pyr"}
    pyr = tuple(_tensor(level, device) for level in jstate.prev_pyr)
    return ft.TrackerState(prev_pyr=pyr, **fields)


def fusion_params_from_jax(jparams) -> imu_fusion.FusionParams:
    return _dc(imu_fusion.FusionParams, jparams)


def fusion_state_from_jax(jstate, device=None) -> imu_fusion.FusionState:
    return _tree(imu_fusion.FusionState, jstate, device)


def noise_from_jax(jnoise, device=None) -> pre.ImuNoise:
    return _tree(pre.ImuNoise, jnoise, device)


def preint_from_jax(jpint, device=None) -> pre.PreintState:
    """A JAX ``PreintState`` (one delta or a stacked batch)."""
    return _tree(pre.PreintState, jpint, device)


def navstate_from_jax(jnav, device=None) -> pre.NavState:
    return _tree(pre.NavState, jnav, device)


def window_from_jax(jws, device=None) -> ba.WindowState:
    return _tree(ba.WindowState, jws, device)


def prior_from_jax(jprior, device=None) -> ba.Prior:
    return _tree(ba.Prior, jprior, device)


def table_from_jax(jtable, device=None) -> fm.FeatureTable:
    return _tree(fm.FeatureTable, jtable, device)


def vio_state_from_jax(jstate, device=None) -> est.VioState:
    return _tree(est.VioState, jstate, device)


def vio_caps_from_jax(jcaps) -> fm.VioCaps:
    return _dc(fm.VioCaps, jcaps)


def vio_params_from_jax(jparams) -> est.VioParams:
    return _dc(est.VioParams, jparams)


def ba_config_from_jax(jcfg) -> ba.BAConfig:
    return _dc(ba.BAConfig, jcfg)


def loop_caps_from_jax(jcaps) -> ld.LoopCaps:
    return _dc(ld.LoopCaps, jcaps)


def loop_db_from_jax(jdb, device=None) -> ld.LoopDB:
    return _tree(ld.LoopDB, jdb, device)


def posegraph_from_jax(jgraph, device=None) -> pg.PoseGraph:
    """A JAX ``PoseGraph`` (the input of `dense_information`) -> the port's."""
    return _tree(pg.PoseGraph, jgraph, device)


def calib_result_from_jax(jres, device=None) -> cal.CalibResult:
    return _tree(cal.CalibResult, jres, device)


def message_from_jax(jmsg, device=None):
    """A JAX ``core.messages`` dataclass (``ImuSample``, ``LidarScan``,
    ``CloudInfo``, ``Odometry``, ``FeatureFrame``, ``CameraImage``) -> the
    port's class of the same name; fields left None stay None."""
    cls = getattr(msg, type(jmsg).__name__)
    return cls(**{f.name: None if getattr(jmsg, f.name) is None
                  else _tensor(getattr(jmsg, f.name), device)
                  for f in dataclasses.fields(cls)})


def lvi_config_from_jax(jcfg) -> lvi.LviConfig:
    """A JAX ``LviConfig`` -> the port's, every nested configuration
    converted (`replay_batch` and the other fields as they are). A pipelined
    JAX configuration (`pipeline_devices` set) has no counterpart: the port
    runs on one device."""
    if jcfg.pipeline_devices is not None:
        raise ValueError("pipeline_devices: the JAX configuration is pipelined; the port "
                         "runs the fused system on one device")
    return _dc(
        lvi.LviConfig, jcfg, lio=config_from_jax(jcfg.lio),
        fusion=fusion_params_from_jax(jcfg.fusion), vio_caps=vio_caps_from_jax(jcfg.vio_caps),
        vio_params=vio_params_from_jax(jcfg.vio_params), ba=ba_config_from_jax(jcfg.ba),
        tracker=tracker_params_from_jax(jcfg.tracker), camera=camera_from_jax(jcfg.camera),
        loop_caps=loop_caps_from_jax(jcfg.loop_caps),
    )


def replay_statics_from_jax(jst) -> rp.ReplayStatics:
    """A JAX ``ReplayStatics`` -> the port's, each nested configuration
    converted."""
    return _dc(rp.ReplayStatics, jst, lio_caps=caps_from_jax(jst.lio_caps),
               lio_params=params_from_jax(jst.lio_params),
               fusion=fusion_params_from_jax(jst.fusion),
               tracker=tracker_params_from_jax(jst.tracker), cam=camera_from_jax(jst.cam),
               vio_caps=vio_caps_from_jax(jst.vio_caps),
               vio_params=vio_params_from_jax(jst.vio_params),
               ba_cfg=ba_config_from_jax(jst.ba_cfg), loop_caps=loop_caps_from_jax(jst.loop_caps))


def replay_carry_from_jax(jcarry, device=None) -> rp.ReplayCarry:
    """A JAX ``ReplayCarry`` -> the port's on `device`, with the host copy
    of the VIO window fill read from its VIO state."""
    return rp.ReplayCarry(
        lio=state_from_jax(jcarry.lio, device),
        fusion=fusion_state_from_jax(jcarry.fusion, device),
        tracker=tracker_state_from_jax(jcarry.tracker, device),
        vio=vio_state_from_jax(jcarry.vio, device),
        loop_db=loop_db_from_jax(jcarry.loop_db, device),
        **{name: _tensor(getattr(jcarry, name), device)
           for name in ("depth_clouds", "depth_valid", "depth_stamps", "depth_slot", "vins")},
        frame_count=int(np.asarray(jcarry.vio.frame_count)),
    )


def lvi_system_from_jax(jsys, device=None, sampler=None) -> lvi.LviSystem:
    """A JAX ``LviSystem`` (interactive path, or with its batched replay
    active and drained: no batch in flight) -> the port's on `device`,
    carrying the device state (LIO map, fusion, tracker, VIO, loop database,
    depth ring; a replay's carry, its rows and statics) and the host state
    (IMU buffers, the fused odometry stream, the VIS odometry, the last fused
    state, frame times, ring stamps and slot, td, the flags and counters)."""
    import copy

    sys_ = lvi.LviSystem(lvi_config_from_jax(jsys.cfg), device=device, sampler=sampler)
    dev = sys_.device
    sys_.lio.state = state_from_jax(jsys.lio.state, dev)
    sys_.lio.scan_counter = jsys.lio.scan_counter
    sys_.fusion = fusion_state_from_jax(jsys.fusion, dev)
    sys_.tracker = tracker_state_from_jax(jsys.tracker, dev)
    sys_.vio = vio_state_from_jax(jsys.vio, dev)
    sys_.loop_db = loop_db_from_jax(jsys.loop_db, dev)
    sys_.depth_clouds = _tensor(jsys.depth_clouds, dev)
    sys_.depth_valid = _tensor(jsys.depth_valid, dev)
    host = ("imu_times", "imu_gyro", "imu_acc", "imu_rpy", "last_image_time",
            "last_lidar_time", "_last_map_time", "lidar_counter", "depth_stamps",
            "depth_slot", "_td", "_vio_initialized", "vins_odom", "last_gps", "lio_odoms",
            "imu_rate_odom", "_last_fused", "trajectory", "vio_frames", "frame_times")
    for name in host:
        setattr(sys_, name, copy.deepcopy(getattr(jsys, name)))
    sys_.trajectory = [(t, np.asarray(x6)) for t, x6 in sys_.trajectory]
    if sys_._ext_rot is None:  # the lidar-frame buffers alias the raw ones
        sys_.imu_gyro_l, sys_.imu_acc_l = sys_.imu_gyro, sys_.imu_acc
    else:
        sys_.imu_gyro_l = copy.deepcopy(jsys.imu_gyro_l)
        sys_.imu_acc_l = copy.deepcopy(jsys.imu_acc_l)
    for slot, img8 in getattr(jsys, "_dbg_kf_imgs", {}).items():
        sys_._debug_keep(_tensor(img8, dev), slot)
    sys_._vio_frame_count = int(np.asarray(jsys.vio.frame_count))
    sys_._fusion_initialized = bool(np.asarray(jsys.fusion.initialized))
    if getattr(jsys, "_replay_active", False):
        # a drained replay: the carry (the device state of record), its
        # statics, the staged rows and their host meta
        sys_._replay_active = True
        sys_._carry = replay_carry_from_jax(jsys._carry, dev)
        sys_._replay_statics = replay_statics_from_jax(jsys._replay_statics)
        sys_._replay_last_frame_t = jsys._replay_last_frame_t
        sys_._ev_rows = [np.array(r, copy=True) for r in jsys._ev_rows]
        sys_._ev_meta = copy.deepcopy(jsys._ev_meta)
        sys_._point_at_carry()
    return sys_
