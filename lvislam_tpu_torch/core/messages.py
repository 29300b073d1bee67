"""Typed message contracts — port of ``lvislam_tpu.core.messages``, the
in-process replacement for the reference's ROS 2 DDS topics (SURVEY.md
§2.7).

Every inter-stage payload is a frozen dataclass of tensors with fixed-shape
arrays and validity masks, as the JAX package's ``flax.struct`` classes:

- ``CloudInfo``  ⇔ `lidar_odometry/msg/CloudInfo.msg:1-36` (the LIS contract).
- ``Odometry``   ⇔ nav_msgs/Odometry incl. the covariance side-channel that
  smuggles reset-id / biases / gravity (`imuPreintegration.cpp:527-534`,
  read at `initial_alignment.h:160-180`).
- ``FeatureFrame`` ⇔ the 6-channel sensor_msgs/PointCloud published by
  feature_tracker (`feature_tracker_node.cpp:170-223`).
- ``ImuSample``, ``LidarScan``, ``CameraImage`` ⇔ raw sensor topics.

``replace`` returns a copy with fields changed (flax's ``.replace``);
``pad_to``, ``validity_mask`` and ``tree_stamp`` are the JAX helpers, the
mask made on an explicit device (the card unless named).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .device import resolve as resolve_device


class _Message:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ImuSample(_Message):
    """One IMU measurement (`sensor_msgs/Imu`): body-frame specific force and
    angular velocity. In batch form the tensors carry a leading time axis."""

    stamp: torch.Tensor  # () or (T,) seconds
    acc: torch.Tensor  # (..., 3)
    gyro: torch.Tensor  # (..., 3)
    quat: torch.Tensor  # (..., 4) orientation wxyz if the driver provides one


@dataclasses.dataclass(frozen=True)
class LidarScan(_Message):
    """Raw lidar scan, Livox CustomMsg flavored (`imageProjection.cpp:240-260`
    moveFromCustomMsg): per-point position, intensity, ring, time offset."""

    stamp: torch.Tensor  # scan header stamp (start of scan), seconds
    xyz: torch.Tensor  # (P, 3)
    intensity: torch.Tensor  # (P,)
    ring: torch.Tensor  # (P,) int32
    time: torch.Tensor  # (P,) seconds relative to stamp
    valid: torch.Tensor  # (P,) bool padding mask


@dataclasses.dataclass(frozen=True)
class CloudInfo(_Message):
    """Inter-stage LIS contract ⇔ `msg/CloudInfo.msg:1-36`; the deskewed
    cloud keeps the raw capacity with masks."""

    stamp: torch.Tensor

    start_ring_index: torch.Tensor  # (N_SCAN,) int32
    end_ring_index: torch.Tensor  # (N_SCAN,) int32
    point_col_ind: torch.Tensor  # (P,) int32 column of each extracted point
    point_range: torch.Tensor  # (P,) float range of each extracted point

    imu_available: torch.Tensor  # () bool
    odom_available: torch.Tensor  # () bool

    imu_rpy_init: torch.Tensor  # (3,) roll, pitch, yaw radians at scan start

    initial_guess_trans: torch.Tensor  # (3,) VINS-provided initial guess
    initial_guess_quat: torch.Tensor  # (4,) wxyz
    odom_reset_id: torch.Tensor  # () int32

    xyz: torch.Tensor  # (P, 3) deskewed points, row-major by ring
    intensity: torch.Tensor  # (P,)
    valid: torch.Tensor  # (P,) bool
    num_valid: torch.Tensor  # () int32

    corner_xyz: torch.Tensor | None = None  # (E, 3) edge features
    corner_valid: torch.Tensor | None = None  # (E,)
    surf_xyz: torch.Tensor | None = None  # (S, 3) planar features
    surf_valid: torch.Tensor | None = None  # (S,)


@dataclasses.dataclass(frozen=True)
class Odometry(_Message):
    """nav_msgs/Odometry equivalent. ``aux`` carries the reference's
    covariance[0..7] side-channel payload explicitly typed:
    [reset_id/failure_count, bax, bay, baz, bgx, bgy, bgz, gravity]
    (`imuPreintegration.cpp:527-534`, `visualization.cpp:96`)."""

    stamp: torch.Tensor
    trans: torch.Tensor  # (3,)
    quat: torch.Tensor  # (4,) wxyz
    vel: torch.Tensor  # (3,)
    ang_vel: torch.Tensor  # (3,)
    aux: torch.Tensor  # (8,) typed side-channel
    degenerate: torch.Tensor  # () bool (`mapOptimization.cpp:1740-1743`)


@dataclasses.dataclass(frozen=True)
class FeatureFrame(_Message):
    """Visual feature frame ⇔ the 6-channel PointCloud of
    `feature_tracker_node.cpp:170-223`."""

    stamp: torch.Tensor
    ids: torch.Tensor  # (F,) int32, -1 = invalid
    xy_norm: torch.Tensor  # (F, 2) undistorted normalized plane
    uv: torch.Tensor  # (F, 2) raw pixel coordinates
    vel: torch.Tensor  # (F, 2) normalized-plane velocity
    depth: torch.Tensor  # (F,) lidar depth, -1 = none
    valid: torch.Tensor  # (F,) bool


@dataclasses.dataclass(frozen=True)
class CameraImage(_Message):
    stamp: torch.Tensor
    image: torch.Tensor  # (H, W) uint8 or float32 grayscale


def pad_to(arr: torch.Tensor, capacity: int, axis: int = 0, fill=0) -> torch.Tensor:
    """Pad (or truncate) `arr` to `capacity` along `axis`, on its device."""
    n = arr.shape[axis]
    if n == capacity:
        return arr
    if n > capacity:
        return arr.narrow(axis, 0, capacity)
    axis = axis % arr.ndim
    pad = [0, 0] * (arr.ndim - 1 - axis) + [0, capacity - n]
    if arr.dtype == torch.bool:
        return F.pad(arr.to(torch.uint8), pad, value=int(bool(fill))).to(torch.bool)
    return F.pad(arr, pad, value=fill)


def validity_mask(n: int, capacity: int, device=None) -> torch.Tensor:
    """(capacity,) bool, the first `n` True, on `device` (the card unless
    named)."""
    return torch.arange(capacity, device=resolve_device(device)) < n


def tree_stamp(msg: Any) -> float:
    return float(msg.stamp)
