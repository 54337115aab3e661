"""Special functions, branch-free with fixed iteration counts.

Port of `cloudy_tpu.ops.special` (the subset the pod variants run: the
fixed-threshold and MovingThreshold gamma paths and the lognormal window
rule), term for term and in the same operation order, so that the torch
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


def div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as one correctly rounded division on any device (torch
    divides a CUDA tensor by a Python float as a product with the float's
    reciprocal: two roundings)."""
    return torch.div(t, torch.as_tensor(c, dtype=t.dtype, device=t.device))


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


# --------------------------------------------------------------------------
# inverse of P(a, .)
# --------------------------------------------------------------------------

# Acklam's rational approximation to the inverse normal CDF (max abs error
# ~1.15e-9): the Wilson–Hilferty start of the gamma inverses.
_NDTRI_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
            1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_NDTRI_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
            6.680131188771972e+01, -1.328068155288572e+01)
_NDTRI_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
            -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_NDTRI_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
            3.754408661907416e+00)


def ndtri(p):
    """Inverse standard normal CDF (Acklam), branch-free over three regions."""
    p = torch.as_tensor(p)
    p = torch.clamp(p, _finfo(p.dtype).tiny, 1.0 - 1e-16)
    p_low = 0.02425
    a, b, c, d = _NDTRI_A, _NDTRI_B, _NDTRI_C, _NDTRI_D

    p_c = torch.clamp(p, p_low, 1.0 - p_low)
    q = p_c - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    x_central = num * q / den

    def tail(pt):
        qt = torch.sqrt(-2.0 * torch.log(pt))
        num_t = ((((c[0] * qt + c[1]) * qt + c[2]) * qt + c[3]) * qt + c[4]) * qt + c[5]
        den_t = (((d[0] * qt + d[1]) * qt + d[2]) * qt + d[3]) * qt + 1.0
        return num_t / den_t

    x_low = tail(torch.clamp(p, max=p_low))
    x_up = -tail(torch.clamp(1.0 - p, max=p_low))
    return torch.where(p < p_low, x_low,
                       torch.where(p > 1.0 - p_low, x_up, x_central))


def _clip_percentile(a, p):
    a, p = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(p))
    dtype = torch.promote_types(a.dtype, p.dtype)
    fi = _finfo(dtype)
    return a.to(dtype), torch.clamp(p.to(dtype), float(fi.tiny), 1.0 - float(fi.epsneg))


def gammaincinv_impl(a, p, n_newton: int = 32, n_iters: int = 128):
    """x with P(a, x) = p: Wilson–Hilferty start and `n_newton` damped Newton
    steps on the series/CF incomplete gamma."""
    a, p = _clip_percentile(a, p)
    tiny = _finfo(a.dtype).tiny
    z = ndtri(p)
    t = 1.0 - 1.0 / (9.0 * a) + z * torch.sqrt(1.0 / (9.0 * a))
    x0 = a * t * t * t
    x_small = exp((torch.log(p) + lgamma(a + 1.0)) / a)
    x0 = torch.where((t > 0.0) & (x0 > 1e3 * tiny), x0, x_small)
    x = torch.clamp(x0, min=tiny)
    lg = lgamma(a)
    for _ in range(n_newton):
        f = gammainc_impl(a, x, n_iters=n_iters) - p
        logdf = (a - 1.0) * torch.log(torch.clamp(x, min=tiny)) - x - lg
        step = f * exp(-logdf)
        step = torch.clamp(step, -9.0 * x, 0.9 * x)
        x = x - step
    return x


def gammainc_gl_shift(a, x, n_nodes: int = 12, lga1=None, log_x=None,
                      shift: int = 4):
    """P(a, x) for any a > 0: GL quadrature at a + shift plus `shift` exact
    downward-recurrence terms."""
    a = torch.as_tensor(a)
    x = torch.as_tensor(x)
    dtype = torch.promote_types(a.dtype, x.dtype)
    a = a.to(dtype)
    x = torch.clamp(x.to(dtype), max=1e6)
    tiny = _finfo(dtype).tiny
    if lga1 is None:
        lga1 = lgamma(a + 1.0)
    if log_x is None:
        log_x = torch.log(torch.clamp(x, min=tiny))
    d = exp(a * log_x - x - lga1)
    d = torch.where(x > 0.0, d, torch.zeros_like(d))
    total = d
    prod = torch.ones_like(a)
    for j in range(1, shift):
        d = d * x / (a + j)
        total = total + d
        prod = prod * (a + j)
    p_hi = gammainc_gl(a + float(shift), x, n_nodes=n_nodes,
                       gln=lga1 + torch.log(prod))
    return torch.clamp(p_hi + total, 0.0, 1.0)


def gammaincinv_gl_impl(a, p, n_iter: int = 3, n_nodes: int = 12):
    """Fast x with P(a, x) = p: max(Wilson–Hilferty, small-x) start and
    `n_iter` Halley steps on the shift-4 GL incomplete gamma (the
    MovingThreshold production inverse; < 2e-5 relative, tests pin it)."""
    a, p = _clip_percentile(a, p)
    tiny = _finfo(a.dtype).tiny
    z = ndtri(p)
    t = 1.0 - 1.0 / (9.0 * a) + z * torch.sqrt(1.0 / (9.0 * a))
    x_wh = torch.where(t > 0.0, a * t * t * t, torch.zeros_like(t))
    lga1 = lgamma(a + 1.0)
    x_small = exp((torch.log(p) + lga1) / a)
    x = torch.clamp(torch.maximum(x_wh, x_small), min=tiny)

    gln4 = lga1 + torch.log((a + 1.0) * (a + 2.0) * (a + 3.0))
    for _ in range(n_iter):
        xs = torch.clamp(x, max=1e6)
        xs_t = torch.clamp(xs, min=tiny)
        d = exp(a * torch.log(xs_t) - xs - lga1)
        d = torch.where(xs > 0.0, d, torch.zeros_like(d))
        deriv = d * a / xs_t
        total = d
        for j in (1.0, 2.0, 3.0):
            d = d * xs / (a + j)
            total = total + d
        p4 = gammainc_gl(a + 4.0, xs, n_nodes=n_nodes, gln=gln4)
        f = torch.clamp(p4 + total, 0.0, 1.0) - p
        step_n = f / torch.clamp(deriv, min=tiny)
        h = 0.5 * ((a - 1.0) / xs_t - 1.0)
        denom = torch.clamp(1.0 - step_n * h, 0.5, 2.0)
        step = step_n / denom
        step = torch.clamp(step, -9.0 * x, 0.9 * x)
        x = x - step
    return x


# --------------------------------------------------------------------------
# error function
# --------------------------------------------------------------------------

# Abramowitz & Stegun 7.1.26 (Hastings): max absolute error 1.5e-7.
_ERF_P = 0.3275911
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def erf_approx(x):
    """Rational-approximation error function (A&S 7.1.26); ``sign(x)·y``,
    so exactly 0 at x = 0 (as `jnp.sign`)."""
    x = torch.as_tensor(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _ERF_P * ax)
    a1, a2, a3, a4, a5 = _ERF_A
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    y = 1.0 - poly * exp(-ax * ax)
    return torch.sign(x) * y


def erf_impl(x, n_iters: int = 128):
    """erf(z) = sign(z) · P(1/2, z²) through the series/CF incomplete gamma."""
    x = torch.as_tensor(x)
    p = gammainc_impl(torch.full_like(x, 0.5), x * x, n_iters=n_iters)
    return torch.sign(x) * p
