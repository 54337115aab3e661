"""Observability utilities (port of cloudy_tpu.utils)."""
