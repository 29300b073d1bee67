"""Core math and host-sync bookkeeping (counterpart of ``lvislam_tpu.core``)."""
