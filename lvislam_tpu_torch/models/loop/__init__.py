"""Visual loop detection (counterpart of ``lvislam_tpu.models.loop``)."""
