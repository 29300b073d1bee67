"""Multi-device placement (counterpart of ``lvislam_tpu.parallel``)."""

from . import mesh, sharded_knn, batch_replay  # noqa: F401
