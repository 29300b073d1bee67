"""Tensor ops and the CUDA kernel wrappers (counterpart of ``lvislam_tpu.ops``)."""
