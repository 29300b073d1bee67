"""lvislam_tpu_torch — the PyTorch + CUDA port of ``lvislam_tpu``.

The JAX package stays the reference; this package mirrors its layout and
module names (``core``, ``ops``, ``models/lio``, ``utils``) so each module's
counterpart is easy to find. Inside, it is PyTorch idiom: plain functions on
tensors, the device taken from the inputs (or passed explicitly where a state
is created), ``NamedTuple`` states in place of pytrees, and Python loops and
branches where JAX has ``lax.while_loop`` / ``lax.cond``.

The JAX package is ported, but for the fused system's placement of its
stages on three devices: the LiDAR-inertial per-scan step
(``models.lio.pipeline``), the visual front end
(``models.vio.feature_tracker``), the IMU side, the VIO estimator, the fused
system on one device (``models.pipeline.LviSystem``, and its batched
replay, ``models.replay``), the entry points and host tools, the
multi-device part (``parallel``), and the repo-root tools (``scripts.bench``,
``scripts.profile``, ``scripts.train_vocab``).
The kernels are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use:

- K1 ``ops.knn_tail``      — voxel-hash candidate scoring + top-5;
- K2 ``ops.gn_partials``   — LOAM coefficients + Gauss-Newton row partials;
- K3 ``ops.clahe.tile_hist`` — CLAHE's per-tile histograms;
- K4 ``ops.clahe.apply_cdf`` — CLAHE's bilinear tile-CDF application.

This package never imports ``jax`` or ``lvislam_tpu``.
"""

import torch as _torch

# Estimation math is precision-critical (3x3 eigensystems, 6x6 normal
# equations): keep every float32 matmul and convolution in full float32, as
# the JAX package does with jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
