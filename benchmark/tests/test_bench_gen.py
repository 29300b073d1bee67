"""The on-card stream generator held to the port's host generator
(``lvislam_tpu_torch.utils.synthetic``) at a few stamps of both laps, on
the CPU (and on the card where there is one)."""

import numpy as np
import pytest
import torch

from benchmark.gen import stream
from benchmark.gen import world as W

LIO_MOTION, LVI_MOTION = dict(scale=3.0, period=40.0), dict(scale=3.0, period=30.0)
LIDAR = dict(rate_hz=10.0, n_scan=4, horizon=6000)


def port():
    from lvislam_tpu_torch.utils import synthetic as syn

    return syn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_scan(ours, ref):
    assert len(ours["xyz"]) == len(ref["xyz"])
    np.testing.assert_allclose(ours["xyz"], ref["xyz"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours["time"], ref["time"])
    np.testing.assert_array_equal(ours["ring"], ref["ring"])
    np.testing.assert_array_equal(ours["intensity"], ref["intensity"])


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_world_is_the_ports_world(seed):
    w = port().default_world(seed=seed)
    ours = W.world_arrays(seed)
    for k, v in ours.items():
        np.testing.assert_array_equal(v, getattr(w, k))


@pytest.mark.parametrize("motion,t", [(LIO_MOTION, [0.0, 13.7, 39.9]),
                                      (LVI_MOTION, [0.005, 7.5, 29.995])])
def test_figure8_pose_and_imu(motion, t):
    traj = port().figure8_trajectory(scale=motion["scale"], period=motion["period"])
    ours = W.Figure8(motion["scale"], motion["period"])
    tt = torch.tensor(t, dtype=torch.float64)
    p, R = ours.pose(tt)
    p0, R0 = traj.pose(np.array(t))
    np.testing.assert_allclose(p.numpy(), p0, atol=1e-12)
    np.testing.assert_allclose(R.numpy(), R0, atol=1e-12)
    w, f = ours.imu(tt)
    w0, f0 = traj.imu(np.array(t))
    np.testing.assert_allclose(w.numpy(), w0, atol=1e-7)
    np.testing.assert_allclose(f.numpy(), f0, atol=1e-5)


def test_lio_lap_is_the_benchs_stream():
    """The lap's first scans, IMU windows and attitudes against
    ``bench_inputs.scan_jobs`` (the port's LIO bench stream)."""
    from lvislam_tpu_torch.scripts import bench_inputs as bi

    lap = stream.lio_lap(0, LIO_MOTION, LIDAR, "cpu", limit=3)
    jobs, finish = bi.scan_jobs(3)
    ref = finish([port().run_job(j) for j in jobs])
    for k, (scan, rel, gyro, rpy) in enumerate(ref):
        stamp, ours = lap.scan(k)
        assert stamp == scan["stamp"]
        _same_scan(ours, scan)
        r, g, a = lap.scan_imu[k]
        np.testing.assert_allclose(r, rel[:23], atol=1e-7)
        np.testing.assert_allclose(g, gyro[:23], atol=1e-6)
        np.testing.assert_allclose(a, rpy, atol=1e-6)


def test_lio_lap_replays_with_the_period():
    lap = stream.lio_lap(5, LIO_MOTION, LIDAR, "cpu", limit=2)
    lap.scan_t = lap.scan_t[:2]
    s0, a = lap.scan(0)
    s2, b = lap.scan(2)
    assert s2 == s0 + LIO_MOTION["period"] and b["xyz"] is a["xyz"]


def test_lvi_lap_is_the_fused_stream():
    """IMU, scans and a frame of the fused lap against
    ``synthetic.lvi_sequence_jobs`` at the MEI 1024x576 rig, at the lap's
    start (the port's sequence stops a scan and a frame short of the lap)."""
    from lvislam_tpu_torch.core.config import CameraIntrinsics

    syn = port()
    cam = CameraIntrinsics()
    cam_d = {k: getattr(cam, k) for k in ("model_type", "image_width", "image_height", "xi",
                                           "k1", "k2", "p1", "p2", "gamma1", "gamma2", "u0",
                                           "v0")}
    lap = stream.lvi_lap(3, LVI_MOTION, LIDAR, cam_d, 200.0, "cpu", limit=2)
    head, jobs = syn.lvi_sequence_jobs(duration=30.0, horizon=6000, cam=cam, world_seed=3,
                                       scale=3.0, period=30.0)
    assert len(lap.imu_t) == len(head["imu_ts"]) == 6000
    np.testing.assert_array_equal(lap.imu_t, head["imu_ts"])
    np.testing.assert_allclose(lap.imu_w, head["w"], atol=1e-7)
    np.testing.assert_allclose(lap.imu_f, head["f"], atol=1e-5)
    np.testing.assert_allclose(lap.imu_rpy, head["rpys"], atol=1e-6)
    np.testing.assert_array_equal(lap.scan_t, head["scan_ts"][:2])
    np.testing.assert_array_equal(lap.frame_t, head["img_ts"][:2])
    n = len(head["scan_ts"])
    for k in range(2):
        _same_scan(lap.scans[k], syn.run_job(jobs[k]))
    ref = syn.run_job(jobs[n + 1])
    diff = np.abs(lap.frames[1].astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_events_come_in_stamp_order_with_the_imu_ahead():
    lap = stream.Lap(period=1.0, scan_t=np.array([0.05, 0.55]), scans=[None, None],
                     imu_t=(np.arange(20) + 1) / 20, imu_w=np.zeros((20, 3)),
                     imu_f=np.zeros((20, 3)), imu_rpy=np.zeros((20, 3), np.float32),
                     frame_t=np.array([0.1, 0.6]), frames=[None, None])
    ev = lap.events(0.15)
    got = [next(ev) for _ in range(8)]
    assert [g[0] for g in got] == pytest.approx([0.05, 0.1, 0.55, 0.6, 1.05, 1.1, 1.55, 1.6])
    fed = [j for g in got for j in g[3]]
    assert fed == list(range(len(fed)))
    for stamp, _, _, imu in got:
        last = imu[-1] if len(imu) else None
        if last is not None:
            assert lap.imu_sample(last)[0] <= stamp + 0.15 + 1e-9


@pytest.mark.cuda
def test_the_card_makes_the_cpus_lap(cuda_device):
    a = stream.lio_lap(7, LIO_MOTION, LIDAR, "cpu", limit=4)
    b = stream.lio_lap(7, LIO_MOTION, LIDAR, cuda_device, limit=4)
    for x, y in zip(a.scans, b.scans):
        _same_scan(y, x)
