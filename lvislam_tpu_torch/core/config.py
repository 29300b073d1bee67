"""Configuration dataclasses — port of ``lvislam_tpu.core.config`` (the
subset the visual front end uses).

``CameraIntrinsics`` mirrors the JAX dataclass field for field, defaults
included: the shipped rig's MEI 1024x576 camera (``params_camera.yaml``).
The tracker's own ``TrackerParams`` lives with the tracker, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CameraIntrinsics:
    """Camodocal camera model parameters (`params_camera.yaml` camera block)."""

    model_type: str = "MEI"  # PINHOLE | MEI | KANNALA_BRANDT | SCARAMUZZA
    image_width: int = 1024
    image_height: int = 576
    # MEI
    xi: float = 1.40630886
    # distortion (radtan, shared by pinhole/MEI)
    k1: float = -0.03678799
    k2: float = 0.2610374
    p1: float = 0.00144626
    p2: float = 0.00035872
    # projection: gamma for MEI, f for pinhole/equidistant
    gamma1: float = 1454.59041
    gamma2: float = 1451.94369
    u0: float = 468.13404
    v0: float = 318.32657
    # equidistant (Kannala-Brandt) coefficients
    kb_k2: float = 0.0
    kb_k3: float = 0.0
    kb_k4: float = 0.0
    kb_k5: float = 0.0
    # scaramuzza polynomials
    scara_poly: Tuple[float, ...] = (0.0,) * 5
    scara_inv_poly: Tuple[float, ...] = (0.0,) * 20
    scara_C: float = 1.0
    scara_D: float = 0.0
    scara_E: float = 0.0
