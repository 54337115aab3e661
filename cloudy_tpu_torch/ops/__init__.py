"""Special functions, quadrature rules and the CUDA kernels (port of cloudy_tpu.ops)."""
