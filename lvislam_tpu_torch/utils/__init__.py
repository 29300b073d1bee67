"""Numpy utilities and the JAX-state converter (counterpart of ``lvislam_tpu.utils``)."""
