"""Models: the 1-D rainshaft (port of cloudy_tpu.models)."""
