"""IMU preintegration engines — port of ``lvislam_tpu.ops.preintegration``.

1. VINS midpoint preintegration with the 15x15 error-state Jacobian and
   covariance, first-order bias correction (``evaluate``) and
   ``repropagate``. One window is a Python loop of ``midpoint_step`` over a
   fixed-capacity buffer; every function takes leading batch dimensions, so
   W windows are one loop of M steps on (W, ...) tensors. Padding samples
   carry dt == 0, which makes the step an exact no-op on the deltas, the
   Jacobian and the covariance (F = I, V = 0): no mask, no count read back.
2. Forward NavState propagation for the IMU-rate predict path, in
   parallel-prefix form (``navstate_predict``) with the sequential recursion
   beside it (``navstate_predict_seq``) and two float64 numpy versions for
   host-side glue.
3. The gyro-only deskew attitude table of the LIO front end.

Error-state ordering: [P(0:3), R(3:6), V(6:9), BA(9:12), BG(12:15)].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve as resolve_device

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class ImuNoise(NamedTuple):
    """Continuous-time IMU noise densities (acc_n / gyr_n / acc_w / gyr_w)."""

    acc_n: torch.Tensor
    gyr_n: torch.Tensor
    acc_w: torch.Tensor
    gyr_w: torch.Tensor

    @classmethod
    def create(cls, acc_n, gyr_n, acc_w, gyr_w, dtype=torch.float32, device=None):
        device = resolve_device(device)
        return cls(*(torch.as_tensor(v, dtype=dtype, device=device)
                     for v in (acc_n, gyr_n, acc_w, gyr_w)))

    def diag18(self) -> torch.Tensor:
        """Diagonal of the 18x18 process-noise matrix."""
        return torch.stack(
            [self.acc_n**2] * 3 + [self.gyr_n**2] * 3
            + [self.acc_n**2] * 3 + [self.gyr_n**2] * 3
            + [self.acc_w**2] * 3 + [self.gyr_w**2] * 3
        )


class PreintState(NamedTuple):
    """Pre-integrated IMU delta between two frames + linearization point.
    Every field may carry leading batch dimensions."""

    delta_p: torch.Tensor  # (3,)
    delta_q: torch.Tensor  # (4,) wxyz
    delta_v: torch.Tensor  # (3,)
    jacobian: torch.Tensor  # (15, 15) d(delta)/d(state at linearization)
    covariance: torch.Tensor  # (15, 15)
    sum_dt: torch.Tensor  # ()
    linearized_ba: torch.Tensor  # (3,)
    linearized_bg: torch.Tensor  # (3,)
    acc_0: torch.Tensor  # (3,) previous accel sample
    gyr_0: torch.Tensor  # (3,) previous gyro sample


def _on(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def preint_init(acc0, gyr0, ba, bg, dtype=torch.float32, device=None) -> PreintState:
    """A fresh delta. The device is that of the first tensor among the
    arguments; with none it is the card unless `device` names another. Leading
    batch dimensions of `acc0` carry over to every field."""
    if device is None:
        device = next((x.device for x in (acc0, gyr0, ba, bg)
                       if isinstance(x, torch.Tensor)), None)
    device = resolve_device(device)
    acc0, gyr0, ba, bg = (_on(x, dtype, device) for x in (acc0, gyr0, ba, bg))
    batch = torch.broadcast_shapes(acc0.shape, gyr0.shape, ba.shape, bg.shape)[:-1]
    z3 = torch.zeros(batch + (3,), dtype=dtype, device=device)
    return PreintState(
        delta_p=z3,
        delta_q=lie.quat_identity(dtype, device).expand(batch + (4,)),
        delta_v=z3,
        jacobian=torch.eye(15, dtype=dtype, device=device).expand(batch + (15, 15)),
        covariance=torch.zeros(batch + (15, 15), dtype=dtype, device=device),
        sum_dt=torch.zeros(batch, dtype=dtype, device=device),
        linearized_ba=ba.expand(batch + (3,)),
        linearized_bg=bg.expand(batch + (3,)),
        acc_0=acc0.expand(batch + (3,)),
        gyr_0=gyr0.expand(batch + (3,)),
    )


def _blocks(rows) -> torch.Tensor:
    """``jnp.block`` of a list of rows of (..., a, b) blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def midpoint_step(state: PreintState, dt, acc_1, gyr_1, noise: ImuNoise) -> PreintState:
    """One midpoint preintegration update. dt == 0 is an exact no-op (used
    for padding). `dt` (...,), `acc_1` / `gyr_1` (..., 3) share the state's
    leading batch dimensions."""
    dtype, device = state.delta_p.dtype, state.delta_p.device
    dt = _on(dt, dtype, device)
    acc_1, gyr_1 = _on(acc_1, dtype, device), _on(gyr_1, dtype, device)
    dq = state.delta_q
    ba, bg = state.linearized_ba, state.linearized_bg
    dt1 = dt[..., None]  # against vectors
    dt2 = dt[..., None, None]  # against matrices

    un_acc_0 = lie.quat_rotate(dq, state.acc_0 - ba)
    un_gyr = 0.5 * (state.gyr_0 + gyr_1) - bg
    new_dq_un = lie.quat_multiply(dq, lie.delta_q(un_gyr * dt1))
    new_dq = lie.quat_normalize(new_dq_un)
    un_acc_1 = lie.quat_rotate(new_dq_un, acc_1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    new_dp = state.delta_p + state.delta_v * dt1 + 0.5 * un_acc * dt1 * dt1
    new_dv = state.delta_v + un_acc * dt1

    # --- error-state transition F (15x15) and noise map V (15x18) ---
    Rk = lie.quat_to_matrix(dq)
    Rk1 = lie.quat_to_matrix(new_dq_un)
    w_x = lie.skew(un_gyr)
    a0_x = lie.skew(state.acc_0 - ba)
    a1_x = lie.skew(acc_1 - ba)
    eye3 = torch.eye(3, dtype=dtype, device=device).expand(Rk.shape)
    i_wdt = eye3 - w_x * dt2
    Rk_a0 = Rk @ a0_x
    Rk1_a1 = Rk1 @ a1_x

    f_pth = -0.25 * Rk_a0 * dt2 * dt2 - 0.25 * Rk1_a1 @ i_wdt * dt2 * dt2
    f_pba = -0.25 * (Rk + Rk1) * dt2 * dt2
    f_pbg = 0.25 * Rk1_a1 * dt2 * dt2 * dt2
    f_vth = -0.5 * Rk_a0 * dt2 - 0.5 * Rk1_a1 @ i_wdt * dt2
    f_vba = -0.5 * (Rk + Rk1) * dt2
    f_vbg = 0.5 * Rk1_a1 * dt2 * dt2
    z3 = torch.zeros_like(eye3)
    eye_dt = eye3 * dt2
    F = _blocks([
        [eye3, f_pth, eye_dt, f_pba, f_pbg],
        [z3, i_wdt, z3, z3, -eye_dt],
        [z3, f_vth, eye3, f_vba, f_vbg],
        [z3, z3, z3, eye3, z3],
        [z3, z3, z3, z3, eye3],
    ])

    v_pa0 = 0.25 * Rk * dt2 * dt2
    v_pth = -0.125 * Rk1_a1 * dt2 * dt2 * dt2
    v_pa1 = 0.25 * Rk1 * dt2 * dt2
    v_va0 = 0.5 * Rk * dt2
    v_vth = -0.25 * Rk1_a1 * dt2 * dt2
    v_va1 = 0.5 * Rk1 * dt2
    hdt = 0.5 * eye_dt
    V = _blocks([
        [v_pa0, v_pth, v_pa1, v_pth, z3, z3],
        [z3, hdt, z3, hdt, z3, z3],
        [v_va0, v_vth, v_va1, v_vth, z3, z3],
        [z3, z3, z3, z3, eye_dt, z3],
        [z3, z3, z3, z3, z3, eye_dt],
    ])

    Ft = F.transpose(-1, -2)
    new_jac = F @ state.jacobian
    new_cov = F @ state.covariance @ Ft + (V * noise.diag18()) @ V.transpose(-1, -2)

    return state._replace(
        delta_p=new_dp, delta_q=new_dq, delta_v=new_dv,
        jacobian=new_jac, covariance=new_cov,
        sum_dt=state.sum_dt + dt,
        acc_0=acc_1.expand(state.acc_0.shape), gyr_0=gyr_1.expand(state.gyr_0.shape),
    )


def preintegrate(state: PreintState, dts: torch.Tensor, accs: torch.Tensor,
                 gyrs: torch.Tensor, noise: ImuNoise) -> PreintState:
    """Integrate a buffer of samples: a loop of midpoint steps over the
    sample axis. `dts` (..., N), `accs` / `gyrs` (..., N, 3); the leading
    dimensions are windows integrated side by side. Padding entries must have
    dt == 0 but should repeat the last valid sample in accs / gyrs (a dt = 0
    step still overwrites acc_0 / gyr_0)."""
    for i in range(dts.shape[-1]):
        state = midpoint_step(state, dts[..., i], accs[..., i, :], gyrs[..., i, :], noise)
    return state


def repropagate(state: PreintState, dts, accs, gyrs, acc0, gyr0, new_ba, new_bg,
                noise: ImuNoise) -> PreintState:
    """Reset the delta and re-run the buffer with new linearization biases."""
    fresh = preint_init(acc0, gyr0, new_ba, new_bg, state.delta_p.dtype,
                        state.delta_p.device)
    return preintegrate(fresh, dts, accs, gyrs, noise)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def preint_compose(a: PreintState, b: PreintState) -> PreintState:
    """Compose two consecutive preintegrations Δ(0→1) ∘ Δ(1→2) → Δ(0→2):

        q02 = q01 ⊗ q12,  v02 = v01 + R01 v12,
        p02 = p01 + v01·Δt12 + R01 p12,

    with first-order composition of the bias Jacobians and covariance."""
    dt2 = b.sum_dt
    R01 = lie.quat_to_matrix(a.delta_q)
    p02 = a.delta_p + a.delta_v * dt2[..., None] + _mv(R01, b.delta_p)
    v02 = a.delta_v + _mv(R01, b.delta_v)
    q02 = lie.quat_normalize(lie.quat_multiply(a.delta_q, b.delta_q))

    eye = torch.eye(3, dtype=R01.dtype, device=R01.device).expand(R01.shape)
    z = torch.zeros_like(eye)
    R12 = lie.quat_to_matrix(b.delta_q)
    Fa = _blocks([
        [eye, -R01 @ lie.skew(b.delta_p), eye * dt2[..., None, None], z, z],
        [z, R12.transpose(-1, -2), z, z, z],
        [z, -R01 @ lie.skew(b.delta_v), eye, z, z],
        [z, z, z, eye, z],
        [z, z, z, z, eye],
    ])
    Gb = _blocks([
        [R01, z, z, z, z],
        [z, eye, z, z, z],
        [z, z, R01, z, z],
        [z, z, z, eye, z],
        [z, z, z, z, eye],
    ])
    cov = (Fa @ a.covariance @ Fa.transpose(-1, -2)
           + Gb @ b.covariance @ Gb.transpose(-1, -2))
    jac = Fa @ a.jacobian + Gb @ b.jacobian
    return PreintState(
        delta_p=p02, delta_q=q02, delta_v=v02,
        jacobian=jac, covariance=cov,
        sum_dt=a.sum_dt + b.sum_dt,
        linearized_ba=a.linearized_ba, linearized_bg=a.linearized_bg,
        acc_0=b.acc_0, gyr_0=b.gyr_0,
    )


def bias_corrected_delta(state: PreintState, bai: torch.Tensor, bgi: torch.Tensor):
    """First-order bias-corrected (delta_p, delta_q, delta_v)."""
    dba = bai - state.linearized_ba
    dbg = bgi - state.linearized_bg
    J = state.jacobian
    blk = lambda r, c: J[..., r:r + 3, c:c + 3]
    dp = state.delta_p + _mv(blk(O_P, O_BA), dba) + _mv(blk(O_P, O_BG), dbg)
    dv = state.delta_v + _mv(blk(O_V, O_BA), dba) + _mv(blk(O_V, O_BG), dbg)
    dq = lie.quat_multiply(state.delta_q, lie.delta_q(_mv(blk(O_R, O_BG), dbg)))
    return dp, dq, dv


def evaluate(state: PreintState, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
             gravity: torch.Tensor) -> torch.Tensor:
    """15-vector preintegration residual; `gravity` is the world-frame
    gravity vector G (typically [0, 0, 9.8x]). Takes leading batch
    dimensions."""
    dp, dq, dv = bias_corrected_delta(state, Bai, Bgi)
    sdt = state.sum_dt[..., None]
    Qi_inv = lie.quat_conjugate(Qi)
    r_p = lie.quat_rotate(Qi_inv, 0.5 * gravity * sdt * sdt + Pj - Pi - Vi * sdt) - dp
    q_err = lie.quat_multiply(lie.quat_conjugate(dq), lie.quat_multiply(Qi_inv, Qj))
    r_q = 2.0 * q_err[..., 1:4]
    r_v = lie.quat_rotate(Qi_inv, gravity * sdt + Vj - Vi) - dv
    return torch.cat([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi], dim=-1)


# ---------------------------------------------------------------------------
# Forward NavState propagation
# ---------------------------------------------------------------------------

class NavState(NamedTuple):
    """World-frame navigation state."""

    pos: torch.Tensor  # (3,)
    quat: torch.Tensor  # (4,) world-from-body
    vel: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)


def navstate_identity(dtype=torch.float32, device=None) -> NavState:
    device = resolve_device(device)
    z3 = torch.zeros(3, dtype=dtype, device=device)
    return NavState(pos=z3, quat=lie.quat_identity(dtype, device), vel=z3, ba=z3, bg=z3)


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


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 0 by log2(n) shifted adds
    (``torch.cumsum`` of floats has no deterministic CUDA implementation)."""
    n, shift = x.shape[0], 1
    while shift < n:
        x = torch.cat([x[:shift], x[shift:] + x[:-shift]], dim=0)
        shift *= 2
    return x


def navstate_predict(state: NavState, dts, accs, gyrs, gravity_vec,
                     prev_acc=None, prev_gyr=None) -> NavState:
    """Dead-reckon the NavState through an IMU buffer (midpoint rule).
    Padding entries: dt == 0. `gravity_vec` is the world gravity acceleration
    as it appears in a_world = R (a_meas - ba) + g, typically (0, 0, -9.8).

    Parallel-prefix form: quaternion normalization commutes with the
    Hamilton product, so the per-sample delta quaternions compose in one
    associative scan and are normalized afterwards; velocities and positions
    then reduce to prefix sums."""
    prev_a = accs[0] if prev_acc is None else prev_acc
    prev_g = gyrs[0] if prev_gyr is None else prev_gyr

    g_prev = torch.cat([prev_g[None], gyrs[:-1]], dim=0)
    un_gyr = 0.5 * (g_prev + gyrs) - state.bg[None]
    dq = lie.delta_q(un_gyr * dts[:, None])  # (N, 4)
    qs = _associative_scan(_qmul, dq)
    qs = lie.quat_multiply(state.quat[None], qs)
    qs = qs / torch.sqrt(torch.sum(qs * qs, dim=-1, keepdim=True))
    q_with0 = torch.cat([state.quat[None], qs], dim=0)  # (N+1, 4)

    a_meas = torch.cat([prev_a[None], accs], dim=0) - state.ba[None]
    w = lie.quat_rotate(q_with0, a_meas) + gravity_vec[None]  # (N+1, 3)
    un_acc = 0.5 * (w[:-1] + w[1:])  # (N, 3)

    dv = un_acc * dts[:, None]
    v_cum = state.vel[None] + _prefix_sum(dv)  # v_i after sample i
    v_prev = torch.cat([state.vel[None], v_cum[:-1]], dim=0)
    pos = state.pos + torch.sum(
        v_prev * dts[:, None] + 0.5 * un_acc * (dts * dts)[:, None], dim=0)
    return state._replace(pos=pos, quat=qs[-1], vel=v_cum[-1])


def _midpoint_nav(pos, quat, vel, pa, pg, dt, acc, gyr, ba, bg, g):
    un_gyr = 0.5 * (pg + gyr) - bg
    new_q = lie.quat_normalize(lie.quat_multiply(quat, lie.delta_q(un_gyr * dt)))
    a0 = lie.quat_rotate(quat, pa - ba) + g
    a1 = lie.quat_rotate(new_q, acc - ba) + g
    un_acc = 0.5 * (a0 + a1)
    return pos + vel * dt + 0.5 * un_acc * dt * dt, new_q, vel + un_acc * dt


def predict_seq_history(pos, quat, vel, ba, bg, dts, accs, gyrs, gravity_vec,
                        prev_acc=None, prev_gyr=None):
    """The literal per-sample recursion; returns the per-sample history
    (ps (N, 3), qs (N, 4), vs (N, 3))."""
    pa = accs[0] if prev_acc is None else prev_acc
    pg = gyrs[0] if prev_gyr is None else prev_gyr
    ps, qs, vs = [], [], []
    for i in range(dts.shape[0]):
        pos, quat, vel = _midpoint_nav(pos, quat, vel, pa, pg, dts[i], accs[i], gyrs[i],
                                       ba, bg, gravity_vec)
        pa, pg = accs[i], gyrs[i]
        ps.append(pos)
        qs.append(quat)
        vs.append(vel)
    return torch.stack(ps), torch.stack(qs), torch.stack(vs)


def navstate_predict_seq(state: NavState, dts, accs, gyrs, gravity_vec,
                         prev_acc=None, prev_gyr=None) -> NavState:
    """Sequential oracle for `navstate_predict`; kept for the parity test and
    as documentation of the recursion being parallelized."""
    ps, qs, vs = predict_seq_history(state.pos, state.quat, state.vel, state.ba, state.bg,
                                     dts, accs, gyrs, gravity_vec, prev_acc, prev_gyr)
    return state._replace(pos=ps[-1], quat=qs[-1], vel=vs[-1])


def _np_rot(qq, x):
    w, xx, yy, zz = qq
    R = np.array([
        [1 - 2 * (yy * yy + zz * zz), 2 * (xx * yy - w * zz), 2 * (xx * zz + w * yy)],
        [2 * (xx * yy + w * zz), 1 - 2 * (xx * xx + zz * zz), 2 * (yy * zz - w * xx)],
        [2 * (xx * zz - w * yy), 2 * (yy * zz + w * xx), 1 - 2 * (xx * xx + yy * yy)],
    ])
    return R @ x


def _np_qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def predict_imu_rate_np(pos, quat, vel, ba, bg, dts, accs, gyrs, gravity_vec,
                        normalize_start: bool = True):
    """Float64 numpy midpoint recursion for host-side glue: the full
    per-sample history (ps (N, 3), qs (N, 4) wxyz normalized, vs (N, 3)), one
    row per input sample, zero-dt pad rows included (they repeat the previous
    state)."""
    f64 = lambda x: np.asarray(x, np.float64)
    p, q, v = f64(pos).copy(), f64(quat).copy(), f64(vel).copy()
    if normalize_start:
        q = q / np.linalg.norm(q)
    ba, bg, g = f64(ba), f64(bg), f64(gravity_vec)
    dts, accs, gyrs = f64(dts), f64(accs), f64(gyrs)
    n = len(dts)
    ps, qs, vs = np.zeros((n, 3)), np.zeros((n, 4)), np.zeros((n, 3))
    pa = accs[0] if len(accs) else np.zeros(3)
    pg = gyrs[0] if len(gyrs) else np.zeros(3)
    for k in range(n):
        dt = dts[k]
        if dt > 0:
            un_gyr = 0.5 * (pg + gyrs[k]) - bg
            q_new = _np_qmul(q, np.concatenate([[1.0], un_gyr * dt * 0.5]))
            q_new = q_new / np.linalg.norm(q_new)
            a0 = _np_rot(q, pa - ba) + g
            a1 = _np_rot(q_new, accs[k] - ba) + g
            un_acc = 0.5 * (a0 + a1)
            p = p + v * dt + 0.5 * un_acc * dt * dt
            v = v + un_acc * dt
            q = q_new
        ps[k], qs[k], vs[k] = p, q, v
        pa, pg = accs[k], gyrs[k]
    return ps, qs, vs


def navstate_predict_np(pos, quat, vel, ba, bg, dts, accs, gyrs, gravity_vec):
    """Float64 numpy `navstate_predict` for host-side glue on tiny sample
    windows: the final (pos, quat, vel) of the same recursion, the incoming
    quaternion taken as it is."""
    if len(dts) == 0:
        return tuple(np.asarray(x, np.float64).copy() for x in (pos, quat, vel))
    ps, qs, vs = predict_imu_rate_np(pos, quat, vel, ba, bg, dts, accs, gyrs, gravity_vec,
                                     normalize_start=False)
    return ps[-1], qs[-1], vs[-1]
