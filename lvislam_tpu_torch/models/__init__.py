"""Subsystems (counterpart of ``lvislam_tpu.models``)."""
