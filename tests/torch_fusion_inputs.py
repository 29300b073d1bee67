"""The smoother's correction sequence that the graph tests run (no JAX, so
the card's tests import it too): corrections at uneven stamps along the
figure-8 with biased, noisy IMU, so that the window's count n varies inside
its fixed N slots; one correction flagged degenerate; one whose absurd
accelerations drive the velocity over ``maxVelocity`` (the failure reset),
after which the sequence runs on from the reset state."""

import numpy as np
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu_torch.models.lio import imu_fusion as fus
from lvislam_tpu_torch.utils import synthetic as syn

TRUE_BG = np.array([0.02, -0.01, 0.015])
TRUE_BA = np.array([0.05, 0.08, -0.06])
PARAMS = fus.FusionParams(imuGravity=syn.GRAVITY, imuAccBiasN=2e-2, imuGyrBiasN=5e-3,
                          priorBiasSigma=0.1)
# correction stamps (s): windows of 20, 10, 20, 6, 4, 20, 10, 20, 2 samples at 200 Hz
STAMPS = (0.10, 0.15, 0.25, 0.28, 0.30, 0.40, 0.45, 0.55, 0.56)
DEGENERATE = 2  # the index of the degenerate correction
FAIL = 5  # the index of the correction that fails


def _pose(traj, tk):
    p, R = traj.pose(np.array([tk]))
    return p[0].astype(np.float32), np.roll(Rsc.from_matrix(R[0]).as_quat(), 1).astype(np.float32)


def corrections(N: int, device):
    """(the initialized state, [(dts, accs, gyrs, lidar_trans, lidar_quat,
    degenerate) for each stamp], the windows' counts n) on `device`, each
    window padded to N slots (dt 0, the last sample repeated)."""
    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    t, w, f = syn.simulate_imu_stream(traj, 0.0, STAMPS[-1] + 0.05, rate=200.0,
                                      gyro_bias=TRUE_BG, accel_bias=TRUE_BA,
                                      gyro_noise=1e-4, accel_noise=1e-3)
    on = lambda a: torch.as_tensor(np.asarray(a), device=device)
    state = fus.fusion_initialize(fus.fusion_init(PARAMS, device=device),
                                  *map(on, _pose(traj, 0.0)), PARAMS)
    steps, counts, t0 = [], [], 0.0
    for k, t1 in enumerate(STAMPS):
        sel = (t > t0 + 1e-9) & (t <= t1 + 1e-9)
        n = int(sel.sum())
        assert 0 < n <= N
        dts = np.zeros(N, np.float32)
        accs, gyrs = np.zeros((N, 3), np.float32), np.zeros((N, 3), np.float32)
        dts[:n] = np.diff(t[sel], prepend=t0)
        accs[:n], gyrs[:n] = f[sel], w[sel]
        if k == FAIL:
            accs[:n] = (500.0, 0.0, 9.81)
        accs[n:], gyrs[n:] = accs[n - 1], gyrs[n - 1]
        p, q = _pose(traj, t1)
        steps.append((on(dts), on(accs), on(gyrs), on(p), on(q), on(k == DEGENERATE)))
        counts.append(n)
        t0 = t1
    return state, steps, counts
