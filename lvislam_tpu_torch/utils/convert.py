"""Carry state across from the JAX package.

Turns a JAX ``LioMapState`` (any NamedTuple or dataclass tree whose leaves
go through ``np.asarray``), ``LioCaps``, ``LioParams``, ``LioConfig``,
``CameraIntrinsics``, ``TrackerParams``, ``TrackerState``, and the IMU and
VIO side's ``FusionState``, ``PreintState``, ``WindowState``, ``Prior``,
``FeatureTable``, ``VioState`` and their parameter dataclasses into the
port's objects on a given device, so both implementations can start from
one state. Works on the objects' field names only; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import CameraIntrinsics
from ..models.lio import imu_fusion, mapping, pipeline
from ..models.vio import estimator as est
from ..models.vio import feature_manager as fm
from ..models.vio import feature_tracker as ft
from ..ops import ba
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
