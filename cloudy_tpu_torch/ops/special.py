"""Special functions, branch-free with fixed iteration counts.

Port of `cloudy_tpu.ops.special` (the subset the fixed-threshold gamma path
runs), term for term and in the same operation order, so that the torch
reference path and the plain twins of the CUDA kernels agree with the JAX
package to rounding. Python-float constants combine with tensors in the
tensor's dtype, as JAX's weakly typed constants do.

Accuracy bounds against scipy are those of the JAX package (pinned in
tests/test_special.py and, for this port, tests/test_torch_special.py).
"""

from __future__ import annotations

import numpy as np
import torch

# Lanczos coefficients (g=7, n=9), standard double-precision set.
_LANCZOS_G = 7.0
_LANCZOS_COEF = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)
_HALF_LOG_2PI = 0.9189385332046727


_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _finfo(dtype):
    return np.finfo(_NUMPY_DTYPE[dtype])


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` as one correctly rounded division in t's dtype (torch's
    ``float / tensor`` computes ``reciprocal(t) * c``: two roundings)."""
    return torch.div(torch.as_tensor(c, dtype=t.dtype, device=t.device), t)


def select(cond, a, b):
    """`jnp.where` with Python-float branches taken in the tensor branch's
    dtype (torch would take a bare float in the default dtype)."""
    ref = a if isinstance(a, torch.Tensor) else b
    a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
    return torch.where(cond, a, b)


def exp(x):
    """Exponential with the JAX package's f64 range extension.

    f32: plain `torch.exp`. f64: for |x| ≥ 85 the JAX package evaluates
    exp(x/9)^9 (cloudy_tpu/ops/special.py:65-77); mirrored here so that f64
    parity with JAX holds where an argument leaves the f32-safe range. The
    CUDA kernels use plain exp; kernel-vs-twin comparisons are row-scaled."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float32:
        return torch.exp(x)
    direct = torch.exp(torch.clamp(x, -85.0, 85.0))
    y = torch.exp(torch.clamp(x, -745.0, 745.0) * (1.0 / 9.0))
    y3 = y * y * y
    chain = y3 * y3 * y3
    out = torch.where(torch.abs(x) < 85.0, direct, chain)
    out = torch.where(x > 745.0, torch.full_like(out, float("inf")), out)
    out = torch.where(x < -745.0, torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), x, out)


def powx(base, q):
    """Overflow-safe ``base**q`` for base > 0 (via exp(q·log base))."""
    base = torch.as_tensor(base)
    b = torch.clamp(base, min=_finfo(base.dtype).tiny)
    return exp(q * torch.log(b))


def lgamma(x):
    """log Γ(x) for x > 0 (Lanczos; lgamma(z) = lgamma(z+1) − log z below 1)."""
    x = torch.as_tensor(x)
    shift = x < 1.0
    z = torch.where(shift, x + 1.0, x)

    zm1 = z - 1.0
    series = torch.full_like(z, _LANCZOS_COEF[0])
    for i, c in enumerate(_LANCZOS_COEF[1:], start=1):
        series = series + rdiv(c, zm1 + i)
    t = zm1 + _LANCZOS_G + 0.5
    out = _HALF_LOG_2PI + (zm1 + 0.5) * torch.log(t) - t + torch.log(series)
    tiny = _finfo(x.dtype).tiny
    return torch.where(shift, out - torch.log(torch.clamp(x, min=tiny)), out)


def lgamma_stirling(x):
    """log Γ(x) for x > 0 with one divide and two logs: Stirling's series at
    z = x + 4 with the shift removed exactly,

        lgamma(x) = [(z−½)ln z − z + ½ln2π + 1/(12z) − 1/(360z³)
                     + 1/(1260z⁵) − 1/(1680z⁷)] − ln(x(x+1)(x+2)(x+3)).

    (The JAX docstring says z = x + 3; its code, ported here, uses x + 4.)
    Absolute error < 4e-9 for x ∈ (0, 50]."""
    x = torch.as_tensor(x)
    tiny = _finfo(x.dtype).tiny
    z = x + 4.0
    log_z = torch.log(z)
    iz = 1.0 / z
    iz2 = iz * iz
    iz3 = iz * iz2
    tail = (
        iz * (1.0 / 12.0)
        - iz3 * (1.0 / 360.0)
        + iz3 * iz2 * (1.0 / 1260.0)
        - iz3 * iz2 * iz2 * (1.0 / 1680.0)
    )
    lg_z = _HALF_LOG_2PI + (z - 0.5) * log_z - z + tail
    shift = torch.clamp(x * (x + 1.0) * (x + 2.0) * (x + 3.0), min=tiny)
    return lg_z - torch.log(shift)


def gamma_ratio(k, e):
    """Γ(k+e)/Γ(k) for k > 0, e ∈ [0, 1], without two lgammas:

        Γ(k+e)/Γ(k) = [Γ(z+e)/Γ(z)] · k(k+1)(k+2)/((k+e)(k+1+e)(k+2+e)),
        z = k + 3,

    with ln Γ(z+e) − ln Γ(z) by the Stirling series through 1/z⁵.
    Relative error < 5e-7 over k ∈ [1e-6, 50] × e ∈ [0, 1]."""
    k = torch.as_tensor(k)
    e = float(e)
    z = k + 3.0
    ze = z + e
    log_z = torch.log(z)
    log_ze = torch.log(ze)
    iz, ize = 1.0 / z, 1.0 / ze
    iz2, ize2 = iz * iz, ize * ize
    tail = (ize - iz) * (1.0 / 12.0) \
        - (ize * ize2 - iz * iz2) * (1.0 / 360.0) \
        + (ize * ize2 * ize2 - iz * iz2 * iz2) * (1.0 / 1260.0)
    d = (ze - 0.5) * log_ze - (z - 0.5) * log_z - e + tail
    front = (k * (k + 1.0) * (k + 2.0)) / (
        (k + e) * (k + 1.0 + e) * (k + 2.0 + e)
    )
    return exp(d) * front


# --------------------------------------------------------------------------
# regularized incomplete gamma P(a, x)
# --------------------------------------------------------------------------


def _gammainc_series_sum(a, x, n_iters):
    """Lower-series sum of P(a,x) (without the prefactor); x < a + 1:
    sum_{n>=0} x^n / (a (a+1) ... (a+n))."""
    term0 = 1.0 / a
    term0, _ = torch.broadcast_tensors(term0, x)
    total, term = term0, term0
    ap = a + torch.zeros_like(term0)
    for _ in range(n_iters):
        ap = ap + 1.0
        term = term * x / ap
        total = total + term
    return total


def _gammainc_contfrac_h(a, x, n_iters):
    """Continued-fraction (modified Lentz) factor of Q(a,x) (without the
    prefactor); x >= a + 1."""
    np_dtype = _finfo(x.dtype).dtype
    # numpy scalar arithmetic in the working type, as the JAX package's
    # `jnp.finfo(dtype).tiny * 1e10` and `1.0 / tiny` evaluate
    tiny_np = np.finfo(np_dtype).tiny * np_dtype.type(1e10)
    tiny = float(tiny_np)
    inv_tiny = float(np_dtype.type(1.0) / tiny_np)

    b = x + 1.0 - a
    c = torch.full_like(b, inv_tiny)
    d = 1.0 / torch.where(torch.abs(b) < tiny, torch.full_like(b, tiny), b)
    h = d
    for i in range(n_iters):
        fi = float(i) + 1.0
        an = -fi * (fi - a)
        b = b + 2.0
        d = an * d + b
        d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
        c = b + an / c
        c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
    return h


def gammainc_impl(a, x, n_iters: int = 128, log_x=None):
    """P(a, x) by the series (x < a + 1) or the continued fraction, each
    evaluated at a safe argument and selected branch-free."""
    a = torch.as_tensor(a)
    x = torch.as_tensor(x)
    dtype = torch.promote_types(a.dtype, x.dtype)
    a = a.to(dtype)
    x = torch.clamp(x.to(dtype), max=1e6)

    ap1 = a + 1.0
    use_series = x < ap1
    x_safe_series = torch.where(use_series, x, ap1)
    x_safe_cf = torch.where(use_series, ap1, x)

    series_sum = _gammainc_series_sum(a, x_safe_series, n_iters)
    h_cf = _gammainc_contfrac_h(a, x_safe_cf, n_iters)

    tiny = _finfo(dtype).tiny
    if log_x is None:
        log_x = torch.log(torch.clamp(x, min=tiny))
    log_ap1 = torch.log(ap1)
    lga = lgamma(a)
    log_xs = torch.where(use_series, log_x, log_ap1)
    log_xc = torch.where(use_series, log_ap1, log_x)
    p_series = series_sum * exp(a * log_xs - x_safe_series - lga)
    q_cf = h_cf * exp(a * log_xc - x_safe_cf - lga)

    out = torch.where(use_series, p_series, 1.0 - q_cf)
    out = torch.clamp(out, 0.0, 1.0)
    return torch.where(x > 0.0, out, torch.zeros_like(out))


def gammainc_gl(a, x, n_nodes: int = 12, gln=None):
    """P(a, x) by fixed Gauss–Legendre integration of the gamma density
    between x and a point deep in the far tail (Numerical Recipes'
    'gammpapprox', branch-free). Max |error| 2.6e-7 at 12 nodes over
    a ∈ [4, 26] × x ∈ (0, 1e6]; requires a ≥ 2. ``gln`` reuses ln Γ(a)."""
    a = torch.as_tensor(a)
    x = torch.as_tensor(x)
    dtype = torch.promote_types(a.dtype, x.dtype)
    a = a.to(dtype)
    x = torch.clamp(x.to(dtype), max=1e6)
    tiny = _finfo(dtype).tiny

    y, w = np.polynomial.legendre.leggauss(n_nodes)

    a1 = a - 1.0
    sqa = torch.sqrt(torch.clamp(a1, min=tiny))
    if gln is None:
        gln = lgamma(a)
    xu_hi = torch.maximum(a1 + 11.5 * sqa, x + 6.0 * sqa)
    xu_lo = torch.clamp(torch.minimum(a1 - 7.5 * sqa, x - 5.0 * sqa), min=0.0)
    above = x > a1
    xu = torch.where(above, xu_hi, xu_lo)
    half = 0.5 * (xu - x)

    s = None
    for yj, wj in zip(y.tolist(), w.tolist()):
        t = torch.clamp(x + half * (yj + 1.0), min=tiny)
        f = exp(a1 * torch.log(t) - t - gln)
        s = wj * f if s is None else s + wj * f
    s = s * half
    out = torch.clamp(torch.where(above, 1.0 - s, -s), 0.0, 1.0)
    return torch.where(x > 0.0, out, torch.zeros_like(out))
