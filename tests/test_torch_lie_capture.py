"""core/lie's constants made on the device against the host-built ones they
replaced (a CUDA graph capture refuses the host copy that ``torch.tensor``
makes), bit for bit: on random inputs, zeros and signed zeros, in float32
and float64, and through ``torch.func.jvp``."""

import math

import numpy as np
import pytest
import torch
from torch.func import jvp

from lvislam_tpu_torch.core import lie


def _old_quat_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def _old_g2R(g):
    ng1 = g / torch.clamp(lie.norm3(g, keepdim=True), min=lie._EPS)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    v = lie.cross(ng1, ng2.expand(ng1.shape))
    c = torch.sum(ng1 * ng2, dim=-1, keepdim=True)
    axis_norm = lie.norm3(v, keepdim=True)
    angle = torch.atan2(axis_norm, c)
    axis = v / torch.clamp(axis_norm, min=lie._EPS)
    R0 = lie.so3_exp(axis * angle)
    yaw = lie.matrix_to_ypr(R0)[..., 0:1]
    yaw_fix = torch.cat([-yaw, torch.zeros_like(yaw), torch.zeros_like(yaw)], dim=-1)
    return lie.ypr_to_matrix(yaw_fix) @ R0


def _old_pose6_to_matrix(x6):
    R = lie.x6_rotation(x6)
    top = torch.cat([R, x6[..., 3:6, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=x6.dtype,
                          device=x6.device).expand(x6.shape[:-1] + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def _conjugate_tangent(fn):
    return lambda q: jvp(fn, (q,), (torch.flip(q, dims=(-1,)) * 0.5 - 0.25,))[1]


CASES = {  # name: (new, old, the input's last axis)
    "quat_conjugate": (lie.quat_conjugate, _old_quat_conjugate, 4),
    "quat_conjugate_jvp": (_conjugate_tangent(lie.quat_conjugate),
                           _conjugate_tangent(_old_quat_conjugate), 4),
    "quat_inverse": (lie.quat_inverse,
                     lambda q: _old_quat_conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True), 4),
    "g2R": (lie.g2R, _old_g2R, 3),
    "pose6_to_matrix": (lie.pose6_to_matrix, _old_pose6_to_matrix, 6),
}


def _inputs(kind: str, n: int, dtype) -> torch.Tensor:
    rng = np.random.default_rng(11)
    shape = (5, 7, n)
    if kind == "random":
        x = rng.normal(0.0, 2.0, shape)
    elif kind == "zeros":
        x = np.zeros(shape)
    else:  # signed zeros, and random entries beside them
        x = np.where(rng.random(shape) < 0.5, -0.0, 0.0)
        x[0] = rng.normal(0.0, 2.0, shape[1:])
    return torch.as_tensor(x, dtype=dtype)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["random", "zeros", "signed_zeros"])
@pytest.mark.parametrize("name", list(CASES))
def test_device_constants_give_the_host_constants_bits(name, kind, dtype):
    new, old, n = CASES[name]
    x = _inputs(kind, n, dtype)
    got, want = new(x), old(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_quat_identity_is_the_host_constant(dtype):
    got = lie.quat_identity(dtype)
    want = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype)
    assert got.shape == (4,) and got.dtype == dtype and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))
    assert not math.copysign(1.0, float(got[1])) < 0  # +0, not -0
