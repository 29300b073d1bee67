"""The camera calibration tool of the port (``ops/chessboard``,
``ops/calibration``) against the JAX package's, on the inputs of
``tests/test_chessboard.py``, ``tests/test_chessboard_calibration_e2e.py``
and ``tests/test_calibration.py``, and the end-to-end flow of the last two
under their own bounds on the CPU."""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial import cKDTree

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from lvislam_tpu.ops import calibration as jcal  # noqa: E402
from lvislam_tpu.ops import chessboard as jcb  # noqa: E402
from lvislam_tpu_torch.ops import calibration as tcal  # noqa: E402
from lvislam_tpu_torch.ops import chessboard as tcb  # noqa: E402
from lvislam_tpu_torch.utils import convert  # noqa: E402
from test_calibration import synth_views  # noqa: E402
from test_chessboard import render_board  # noqa: E402
from test_chessboard_calibration_e2e import COLS, ROWS, SQ, view_homography  # noqa: E402
import test_chessboard_calibration_e2e as e2e  # noqa: E402

torch.set_num_threads(1)


def boards():
    """The three boards of `tests/test_chessboard.py` (axis-aligned, rotated
    with perspective, clutter) and the first two views of the e2e test."""
    out = {"axis": render_board(np.array([[24.0, 0, 60.0], [0, 24.0, 50.0], [0, 0, 1.0]]), 5, 7)[0]}
    th = np.deg2rad(18.0)
    Hm = np.eye(3)
    Hm[:2, :2] = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) * 22.0
    Hm[:2, 2] = [90.0, 70.0]
    Hm[2, :2] = [4e-4, -3e-4]
    out["perspective"] = render_board(Hm, 5, 7)[0]
    out["clutter"] = np.random.default_rng(1).normal(0.5, 0.1, (240, 320)).astype(np.float32)
    for k, (rv, tv) in enumerate(e2e_views()[:2]):
        out[f"e2e_{k}"] = render_board(view_homography(rv, tv), ROWS, COLS, seed=7)[0]
    return out


def e2e_views():
    rng = np.random.default_rng(4)
    views = []
    for _ in range(8):
        rv = np.array([rng.uniform(0.2, 0.35) * rng.choice([-1, 1]),
                       rng.uniform(0.2, 0.35) * rng.choice([-1, 1]),
                       rng.uniform(-0.3, 0.3)])
        tv = np.array([rng.uniform(-0.135, -0.105), rng.uniform(-0.105, -0.075),
                       rng.uniform(0.42, 0.65)])
        views.append((rv, tv))
    return views


BOARDS = boards()


@pytest.mark.parametrize("name", list(BOARDS))
def test_find_chessboard_equals_jax(name):
    """The saddle response within 5e-8 (the Gaussian is summed in another
    order than XLA's convolution: a float32 rounding of the smoothed [0, 1]
    image moves the product of its second differences by ~1e-8; peaks are
    1e-4..4e-3); `found` and the ordered corners equal JAX's (same NMS
    peaks, same ties, same ordering)."""
    img = BOARDS[name]
    rj = np.asarray(jcb.saddle_response(jnp.asarray(img)))
    rt = tcb.saddle_response(torch.as_tensor(img)).numpy()
    assert np.abs(rt - rj).max() <= 5e-8
    cj, fj = jcb.find_chessboard(jnp.asarray(img), 5, 7)
    ct, ft = tcb.find_chessboard(torch.as_tensor(img), 5, 7)
    assert bool(ft) == bool(fj) == (name != "clutter")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_top_k_ties_go_to_the_lower_index():
    """Equal saddle peaks: JAX's `lax.top_k` order (lower flat index first)
    decides which corners are kept; the port keeps the same ones."""
    img = np.zeros((64, 64), np.float32)
    for y in (16, 32, 48):
        for x in (16, 32, 48):
            img[y - 8:y, x - 8:x] = img[y:y + 8, x:x + 8] = 1.0
    cj, fj = jcb.find_chessboard(jnp.asarray(img), 2, 2)
    ct, ft = tcb.find_chessboard(torch.as_tensor(img), 2, 2)
    assert bool(ft) == bool(fj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_board_object_points_equal_jax():
    np.testing.assert_array_equal(tcb.board_object_points(3, 4, 0.05, device="cpu").numpy(),
                                  np.asarray(jcb.board_object_points(3, 4, 0.05)))


CASES = {
    "PINHOLE": ([460.0, 455.0, 320.0, 240.0, -0.05, 0.02, 1e-3, -5e-4],
                [0.03, -0.03, 0.01, -0.01, -1.0, -1.0, -1.0, -1.0]),
    "MEI": ([1.0, 900.0, 890.0, 500.0, 300.0, -0.03, 0.01, 5e-4, -2e-4],
            [0.1, 0.05, -0.05, 0.01, -0.01, -1.0, -1.0, -1.0, -1.0]),
}


def calib_inputs(model):
    truth, perturb = CASES[model]
    board, img_pts, rv, tv = synth_views(np.asarray(truth, np.float32), model)
    V, N, _ = img_pts.shape
    intr0 = (np.asarray(truth, np.float32) * (1 + np.asarray(perturb))).astype(np.float32)
    return (board, img_pts.astype(np.float32), np.ones((V, N), bool), intr0,
            (rv + 0.02).astype(np.float32), (tv * 1.05).astype(np.float32))


@pytest.mark.parametrize("model", list(CASES))
def test_project_equals_jax(model):
    """`_project` on the same camera-frame points: within 1e-4 px (float32,
    another summation order in the distortion terms)."""
    truth = np.asarray(CASES[model][0], np.float32)
    pc = (np.random.default_rng(3).normal(size=(64, 3)) * [0.5, 0.5, 0.2] + [0, 0, 2.0])
    pc = pc.astype(np.float32)
    a = np.asarray(jcal._project(jnp.asarray(truth), jnp.asarray(pc), model))
    b = tcal._project(torch.as_tensor(truth), torch.as_tensor(pc), model).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


@pytest.mark.parametrize("model", list(CASES))
def test_calibrate_equals_jax(model):
    """`tests/test_calibration.py`'s solve (20 iterations, float32) in both
    packages: the intrinsics within 1e-5 of each other relative to each
    value's scale (distortion terms 2e-4 absolute: they are the weakly
    observed ones and move most with float32 rounding), the poses within
    1e-4, the RMS within 1e-6 px; the test's own bounds on the port's
    result. The JAX result carried by `calib_result_from_jax` equals JAX's."""
    args = calib_inputs(model)
    j = jcal.calibrate(*map(jnp.asarray, args), model_type=model, iterations=20)
    t = tcal.calibrate(*map(torch.as_tensor, args), model_type=model, iterations=20)
    ji, ti = np.asarray(j.intrinsics), t.intrinsics.numpy()
    nd = len(ji) - 4  # the leading intrinsics; the last four are distortion
    np.testing.assert_allclose(ti[:nd], ji[:nd], rtol=1e-5)
    np.testing.assert_allclose(ti[nd:], ji[nd:], atol=2e-4)
    np.testing.assert_allclose(t.rvecs.numpy(), np.asarray(j.rvecs), atol=1e-4)
    np.testing.assert_allclose(t.tvecs.numpy(), np.asarray(j.tvecs), atol=1e-4)
    assert abs(float(t.rms_px) - float(j.rms_px)) < 1e-6
    truth = CASES[model][0]
    assert float(t.rms_px) < 0.2
    if model == "PINHOLE":
        np.testing.assert_allclose(ti[:2], truth[:2], rtol=5e-3)
        np.testing.assert_allclose(ti[2:4], truth[2:4], atol=3.0)
        np.testing.assert_allclose(ti[4], truth[4], atol=1e-2)
    else:
        np.testing.assert_allclose(ti[3:5], truth[3:5], rtol=2e-2)
    carried = convert.calib_result_from_jax(j, device="cpu")
    for a, b in zip(carried, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_detect_then_calibrate_recovers_focal():
    """`tests/test_chessboard_calibration_e2e.py` through the port on the
    CPU under that test's bounds: every view found, corners within 0.7 px,
    rms < 0.3 px, focal within 1 %, principal point within 10 px."""
    obj = tcb.board_object_points(ROWS, COLS, SQ, device="cpu")[:, :2]
    views = e2e_views()
    img_pts = []
    for rv, tv in views:
        img, true_pix = render_board(view_homography(rv, tv), ROWS, COLS, H=240, W=320, seed=7)
        corners, found = tcb.find_chessboard(torch.as_tensor(img), ROWS, COLS)
        assert bool(found)
        d, idx = cKDTree(corners.numpy()).query(true_pix)
        assert sorted(idx.tolist()) == list(range(ROWS * COLS))
        assert d.max() < 0.7, d.max()
        img_pts.append(corners.numpy()[idx])
    img_pts = torch.as_tensor(np.stack(img_pts).astype(np.float32))
    V, N = img_pts.shape[:2]
    F, CX, CY = e2e.F, e2e.CX, e2e.CY
    intr0 = torch.tensor([F * 1.12, F * 0.9, CX + 6, CY - 5, 0, 0, 0, 0], dtype=torch.float32)
    rv0 = torch.as_tensor(np.stack([v[0] for v in views]).astype(np.float32) + 0.02)
    tv0 = torch.as_tensor((np.stack([v[1] for v in views]) * 1.08).astype(np.float32))
    res = tcal.calibrate(obj, img_pts, torch.ones((V, N), dtype=torch.bool), intr0, rv0, tv0,
                         model_type="PINHOLE", iterations=25)
    est = res.intrinsics.numpy()
    assert float(res.rms_px) < 0.3, float(res.rms_px)
    np.testing.assert_allclose(est[0], F, rtol=0.01)
    np.testing.assert_allclose(est[1], F, rtol=0.01)
    np.testing.assert_allclose(est[2:4], [CX, CY], atol=10.0)


def test_synthetic_board_copies_equal_the_tests():
    """The port's copies of the calibration tests' inputs (for the card,
    which has neither JAX nor the test tree's JAX imports): the rendered
    board and its corners, the e2e homographies and poses bit for bit; the
    synthetic observations within 1e-4 px (each package projects with its
    own `_project`, then the same noise)."""
    from lvislam_tpu_torch.utils import synthetic as tsyn

    for k, ((rv, tv), (rv2, tv2)) in enumerate(zip(e2e_views(), tsyn.calibration_board_poses())):
        np.testing.assert_array_equal(rv, rv2)
        np.testing.assert_array_equal(tv, tv2)
        Hm = view_homography(rv, tv)
        np.testing.assert_array_equal(
            tsyn.board_view_homography(rv, tv, e2e.F, e2e.CX, e2e.CY, SQ), Hm)
        if k < 2:
            for a, b in zip(render_board(Hm, ROWS, COLS, seed=7),
                            tsyn.render_board(Hm, ROWS, COLS, seed=7)):
                np.testing.assert_array_equal(a, b)
    for model, (truth, _) in CASES.items():
        intr = np.asarray(truth, np.float32)
        ref = synth_views(intr, model)
        got = tsyn.calibration_views(
            lambda pc: tcal._project(torch.as_tensor(intr), torch.as_tensor(pc), model).numpy(),
            intr)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[3], ref[3])
