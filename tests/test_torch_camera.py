"""The port's four camera models against the JAX package on the CPU.

Tolerances: unit rays within 1e-6 (measured ≤ 2.4e-7); pixels within
rtol 1e-6 of their value (≈ 1e-3 px at 1000 px: the projections'
trigonometry rounds differently, measured ≤ 1.5e-4 px); normalized-plane
points within 1e-5 relative on rays in front of the camera (a ray near
z = 0 divides by almost nothing, and its point is arbitrarily far)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.core.config import CameraIntrinsics as JCam
from lvislam_tpu.ops import camera as jcam
from lvislam_tpu_torch.core.config import CameraIntrinsics
from lvislam_tpu_torch.ops import camera as tcam
from lvislam_tpu_torch.utils import convert

torch.set_num_threads(1)

CAMS = {
    "MEI": JCam(),  # the shipped rig
    "PINHOLE": JCam(model_type="PINHOLE", gamma1=460.0, gamma2=460.0, u0=512.0,
                    v0=288.0, k1=-0.03, k2=0.007, p1=1e-4, p2=-2e-4),
    "KANNALA_BRANDT": JCam(model_type="KANNALA_BRANDT", gamma1=350.0, gamma2=350.0,
                           u0=512.0, v0=288.0, kb_k2=-0.01, kb_k3=0.004,
                           kb_k4=-0.002, kb_k5=0.0005),
    "SCARAMUZZA": JCam(model_type="SCARAMUZZA", u0=512.0, v0=288.0,
                       scara_poly=(300.0, 0.0, -5e-4, 1e-8, 0.0),
                       scara_inv_poly=(300.0, 200.0, 20.0, -10.0, 5.0) + (0.0,) * 15,
                       scara_C=1.0, scara_D=0.001, scara_E=-0.002),
}


def _uv(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 1024, n), rng.uniform(0, 576, n)], -1).astype(np.float32)


def test_camera_intrinsics_mirror_jax():
    assert convert.camera_from_jax(JCam()) == CameraIntrinsics()
    for c in CAMS.values():
        assert convert.camera_from_jax(c).__dict__ == c.__dict__


@pytest.mark.parametrize("model", list(CAMS))
def test_lift_projective(model):
    c = CAMS[model]
    uv = _uv()
    ref = np.asarray(jcam.lift_projective(jnp.asarray(uv), c))
    got = tcam.lift_projective(torch.from_numpy(uv), convert.camera_from_jax(c)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("model", list(CAMS))
def test_space_to_plane(model):
    c = CAMS[model]
    rng = np.random.default_rng(1)
    P = rng.normal(size=(400, 3)).astype(np.float32)
    P[:, 2] = np.abs(P[:, 2]) + 0.5
    ref = np.asarray(jcam.space_to_plane(jnp.asarray(P), c))
    got = tcam.space_to_plane(torch.from_numpy(P), convert.camera_from_jax(c)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("model", list(CAMS))
def test_normalized_plane(model):
    c = CAMS[model]
    uv = _uv(seed=2)
    front = np.asarray(jcam.lift_projective(jnp.asarray(uv), c))[:, 2] > 0.1
    ref = np.asarray(jcam.normalized_plane(jnp.asarray(uv), c))[front]
    got = tcam.normalized_plane(torch.from_numpy(uv), convert.camera_from_jax(c)).numpy()[front]
    assert front.sum() > 100
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["MEI", "PINHOLE", "KANNALA_BRANDT"])
def test_round_trip(model):
    """lift ∘ project ≈ identity on rays inside the field of view (the JAX
    package's own round-trip criterion, 1e-4 on the ray)."""
    c = convert.camera_from_jax(CAMS[model])
    rng = np.random.default_rng(3)
    ray = rng.normal(size=(200, 3))
    ray[:, 2] = np.abs(ray[:, 2]) + 0.8
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    uv = tcam.space_to_plane(torch.tensor(ray * 3.0, dtype=torch.float32), c)
    keep = ((uv[:, 0] > 50) & (uv[:, 0] < 950) & (uv[:, 1] > 50) & (uv[:, 1] < 550)).numpy()
    back = tcam.lift_projective(uv, c).numpy()
    assert keep.sum() > 50
    np.testing.assert_allclose(np.sum(ray * back, axis=-1)[keep], 1.0, atol=1e-4)
