"""The port's command-line entry points (``python -m lvislam_tpu_torch.scripts.<name>``)."""
