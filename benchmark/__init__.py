"""The benchmark of cloudy_tpu_torch (see run.py)."""
