"""Measurement scripts of the port (run as ``python -m cloudy_tpu_torch.tools.<name>``)."""
