"""IMU preintegration — port of ``lvislam_tpu.ops.preintegration``.

Only the gyro deskew table the LIO front end needs is ported so far; the
VINS midpoint preintegration and NavState propagation come with the IMU
slice.
"""

from __future__ import annotations

import torch

from ..core import lie


def _qmul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _associative_scan(fn, elems: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along dim 0 with the same pairing tree as
    ``jax.lax.associative_scan`` (so the rounding of the products matches):
    combine adjacent pairs, scan the half-length sequence recursively, then
    fill in the even positions."""
    n = elems.shape[0]
    if n < 2:
        return elems
    reduced = fn(elems[0:-1:2], elems[1::2])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(odd[:-1], elems[2::2])
    else:
        even = fn(odd, elems[2::2])
    even = torch.cat([elems[0:1], even], dim=0)
    out = torch.empty_like(elems)
    out[0::2] = even
    out[1::2] = odd
    return out


def gyro_rotation_table(dts: torch.Tensor, gyrs: torch.Tensor) -> torch.Tensor:
    """Cumulative gyro-only rotation quaternions over a sample buffer (the
    deskew attitude table). Returns (N+1, 4): entry i is the rotation from
    buffer start to just after sample i-1."""
    dq = lie.delta_q(gyrs * dts[:, None])
    qs = _associative_scan(_qmul, dq)
    qs = qs / torch.sqrt(torch.sum(qs * qs, dim=-1, keepdim=True))
    q0 = lie.quat_identity(gyrs.dtype, gyrs.device)
    return torch.cat([q0[None], qs], dim=0)
