"""Parameter calibration: batched ensemble Kalman methods and gradient fits.

Port of `cloudy_tpu.calibrate`. The reference (CliMA/Cloudy.jl) has none: in
the CliMA stack its parameters are calibrated by EnsembleKalmanProcesses.jl,
which drives the model as a black box. Here the ensemble is one batched
forward pass on the device and the update is a few small products and
solves. No iteration reads a value back to the host (the one exception is
inside cuSOLVER's Cholesky, which copies a status back once per update on
the card): the histories are stacked tensors, read by the caller.

- `run_eki`: perturbed-observation Ensemble Kalman Inversion
  (Iglesias/Law/Stuart 2013),
  θ⁺ = θ + C_θg (C_gg + Γ)⁻¹ (y + η − g), η ~ N(0, Γ);
- `run_sparse_eki`: EKI with a proximal l1 step and a debiasing polish (the
  EKP.jl `SparseInversion` capability);
- `run_eks`: the Ensemble Kalman Sampler (Garbuno-Inigo/Hoffmann/Li/Stuart
  2020);
- `run_uki`: Unscented Kalman Inversion (Huang/Schneider/Stuart 2022),
  deterministic;
- `fit_gradient`: gradient descent through autograd (`torch.optim.Adam` by
  default, the update of `optax.adam`).

**The forward is batched.** Where the JAX functions take a per-member
``forward(theta [P]) -> [D]`` and `jax.vmap` it (folding the members into
the Pallas grid), these take ``forward(theta [J, P]) -> [J, D]`` and the
forward folds the members onto its lanes itself: `torch.func.vmap` cannot
map over a launch of a hand-written kernel. A per-member pure-torch forward
may be wrapped in `torch.func.vmap` by the caller. ``transform`` composes
as in the JAX package, ``forward(transform(theta))``.

**Randomness.** Each JAX ``key`` becomes a `torch.Generator` on the
forward's device, seeded by the caller; every draw keeps the JAX
distribution (η ~ N(0, Γ) by the factor U·√S of Γ's SVD, as
``jax.random.multivariate_normal(..., method="svd")``, computed once per
run). The updates themselves are draw-free (`_eki_update`, `_eks_update`,
`_sparse_eki_loop`), so the tests feed them the JAX package's own draws.

**Linear algebra** stays in `torch.linalg`, as the JAX package leaves it to
XLA. A Cholesky factor of a matrix that is not positive definite is all
NaN, as JAX's is: nothing raises inside a run on the card.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import torch


class EKIResult(NamedTuple):
    """`theta`: final ensemble [J, P]. `theta_history`: [n_iters+1, J, P].
    `misfit_history`: [n_iters+1] mean data misfit ‖Γ^{-1/2}(y − g)‖²/D
    (whitened mean-square residual; ~1 at the noise floor)."""

    theta: torch.Tensor
    theta_history: torch.Tensor
    misfit_history: torch.Tensor


class UKIResult(NamedTuple):
    """`mean` [P] and `cov` [P, P] of the final Gaussian; the histories
    include the prior state at index 0."""

    mean: torch.Tensor
    cov: torch.Tensor
    mean_history: torch.Tensor
    cov_history: torch.Tensor
    misfit_history: torch.Tensor


class GradFitResult(NamedTuple):
    params: torch.Tensor
    loss_history: torch.Tensor


def _as_cov(noise_cov, d: int, like: torch.Tensor) -> torch.Tensor:
    """Accept a scalar, a diagonal [D], or a full [D, D] covariance."""
    g = torch.as_tensor(noise_cov, dtype=like.dtype, device=like.device)
    if g.ndim == 0:
        return g * torch.eye(d, dtype=like.dtype, device=like.device)
    if g.ndim == 1:
        return torch.diag(g)
    return g


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; all NaN where `a` is not positive definite
    (as `jnp.linalg.cholesky`), without a host check."""
    factor, info = torch.linalg.cholesky_ex(a, check_errors=False)
    return torch.where((info == 0)[..., None, None], factor,
                       torch.full_like(factor, float("nan")))


def _solve_pos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹ b for a symmetric positive definite `a` (``solve(...,
    assume_a="pos")``): the Cholesky factor and two triangular solves, as
    `cho_solve`. (`torch.cholesky_solve` reads a status back to the host on
    the card, a synchronisation in every iteration.)"""
    chol = _cholesky(a)
    z = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mT, z, upper=True)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹ b by LU; inf or NaN where `a` is singular, as `jnp.linalg.solve`,
    and no status read back to the host."""
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


def _batched(forward: Callable, transform: Optional[Callable]) -> Callable:
    return forward if transform is None else (lambda t: forward(transform(t)))


def _misfit_fn(y: torch.Tensor, gamma: torch.Tensor) -> Callable:
    """Mean whitened square residual of each row of g [J, D] (or of one
    [D] mean) against y, averaged."""
    chol = _cholesky(gamma)

    def misfit(g):
        r = y - g
        r = torch.linalg.solve_triangular(chol, r.reshape(-1, y.shape[0]).T, upper=False)
        return torch.mean(r ** 2)

    return misfit


def _setup(theta0, y, noise_cov):
    theta0 = torch.atleast_2d(torch.as_tensor(theta0))
    y = torch.as_tensor(y, dtype=theta0.dtype, device=theta0.device)
    return theta0, y, _as_cov(noise_cov, y.shape[0], theta0)


def _noise_factor(gamma: torch.Tensor) -> torch.Tensor:
    """U·√S of Γ's SVD: η = ξ·factorᵀ with ξ ~ N(0, I) has covariance Γ."""
    u, s, _ = torch.linalg.svd(gamma)
    return u * torch.sqrt(s)[None, :]


def _normal(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _etas(generator: torch.Generator, factor: torch.Tensor, n_ens: int, n: int):
    """`n` draws of η ~ N(0, Γ) [J, D] for an ensemble of `n_ens`."""
    for _ in range(n):
        yield _normal(generator, (n_ens, factor.shape[0]), factor) @ factor.T


def _eki_update(theta, g, y, gamma, eta):
    """One perturbed-observation EKI update, given the draws η [J, D]:
    theta [J, P], g [J, D] = G(θ), y [D], Γ [D, D] → θ⁺ [J, P]."""
    n_ens = theta.shape[0]
    th_a = theta - torch.mean(theta, dim=0, keepdim=True)
    g_a = g - torch.mean(g, dim=0, keepdim=True)
    c_thg = th_a.T @ g_a / (n_ens - 1)  # [P, D]
    c_gg = g_a.T @ g_a / (n_ens - 1)  # [D, D]
    resid = y[None, :] + eta - g
    sol = _solve_pos(c_gg + gamma, resid.T)  # [D, J]
    return theta + (c_thg @ sol).T


def eki_step(theta, g, y, noise_cov, generator: torch.Generator):
    """One perturbed-observation EKI update with η ~ N(0, Γ) drawn from
    `generator`: theta [J, P], g [J, D], y [D], noise_cov scalar | [D] |
    [D, D]."""
    theta, y, gamma = _setup(theta, y, noise_cov)
    eta = next(_etas(generator, _noise_factor(gamma), theta.shape[0], 1))
    return _eki_update(theta, g, y, gamma, eta)


def _iterate(update, fwd, theta, draws, misfit):
    """Apply ``update(theta, g, draw)`` once per draw; returns (θ, the θ
    before each update, the misfit of each forward)."""
    th_hist, mf_hist = [], []
    for draw in draws:
        g = fwd(theta)
        th_hist.append(theta)
        mf_hist.append(misfit(g))
        theta = update(theta, g, draw)
    return theta, th_hist, mf_hist


def _result(fwd, theta, th_hist, mf_hist, misfit) -> EKIResult:
    """Close a run: one last forward for the final misfit."""
    return EKIResult(theta, torch.stack(th_hist + [theta]),
                     torch.stack(mf_hist + [misfit(fwd(theta))]))


def _eki_loop(fwd, theta0, y, gamma, etas: Iterable) -> EKIResult:
    """EKI iterations, one per draw η in `etas`."""
    misfit = _misfit_fn(y, gamma)
    update = lambda th, g, eta: _eki_update(th, g, y, gamma, eta)  # noqa: E731
    return _result(fwd, *_iterate(update, fwd, theta0, etas, misfit), misfit)


def run_eki(
    forward: Callable,
    theta0,
    y,
    noise_cov,
    n_iters: int,
    generator: torch.Generator,
    transform: Optional[Callable] = None,
) -> EKIResult:
    """Run `n_iters` EKI iterations. ``forward(theta [J, P]) -> [J, D]`` is
    the batched forward map; ``transform`` maps the unconstrained θ the EKI
    updates into the model's parameter space (e.g. `torch.exp`); misfits are
    in data space either way."""
    theta0, y, gamma = _setup(theta0, y, noise_cov)
    etas = _etas(generator, _noise_factor(gamma), theta0.shape[0], n_iters)
    return _eki_loop(_batched(forward, transform), theta0, y, gamma, etas)


def ensemble_init(generator: torch.Generator, prior_mean, prior_std, n_ens: int,
                  dtype: Optional[torch.dtype] = None):
    """Draw an [J, P] initial ensemble on the generator's device from an
    independent-normal prior."""
    mean = torch.atleast_1d(torch.as_tensor(prior_mean, dtype=dtype,
                                            device=generator.device))
    std = torch.broadcast_to(torch.as_tensor(prior_std, dtype=mean.dtype,
                                             device=mean.device), mean.shape)
    return mean[None, :] + std[None, :] * _normal(generator, (n_ens, mean.shape[0]), mean)


def _sparse_eki_loop(fwd, theta0, y, gamma, etas, inflate, etas_polish,
                     lambda_l1: float, prune_below: float, mask) -> EKIResult:
    """The two phases of `run_sparse_eki`, given the draws: `etas` for the
    support identification, `inflate` [J, P] ~ N(0, I) for the
    re-inflation and `etas_polish` for the polish (None and empty when the
    polish has no iterations)."""
    misfit = _misfit_fn(y, gamma)

    def prox(theta):
        soft = torch.sign(theta) * torch.clamp(torch.abs(theta) - lambda_l1, min=0.0)
        soft = torch.where(torch.abs(soft) < prune_below, torch.zeros_like(soft), soft)
        return mask * soft + (1.0 - mask) * theta

    theta, th_hist, mf_hist = _iterate(
        lambda th, g, eta: prox(_eki_update(th, g, y, gamma, eta)),
        fwd, theta0, etas, misfit)
    # phase 2: freeze the identified support, refit without shrinkage
    active = (torch.abs(torch.mean(theta, dim=0)) > 0.0).to(theta0.dtype)
    support = torch.where(mask > 0, active, torch.ones_like(active))[None, :]
    theta = support * theta
    if inflate is not None:
        # phase 1 collapses the ensemble and biases the survivors low:
        # re-inflate around the pruned mean with the worst-case shrinkage
        spread = lambda_l1 * len(th_hist) + prune_below
        theta = support * (torch.mean(theta, dim=0)[None, :] + spread * inflate)
        theta, th2, mf2 = _iterate(
            lambda th, g, eta: support * _eki_update(th, g, y, gamma, eta),
            fwd, theta, etas_polish, misfit)
        th_hist, mf_hist = th_hist + th2, mf_hist + mf2
    return _result(fwd, theta, th_hist, mf_hist, misfit)


def run_sparse_eki(
    forward: Callable,
    theta0,
    y,
    noise_cov,
    n_iters: int,
    generator: torch.Generator,
    lambda_l1: float = 1e-2,
    prune_below: float = 0.0,
    sparse_idx=None,
    polish_iters: Optional[int] = None,
    transform: Optional[Callable] = None,
) -> EKIResult:
    """Sparsity-promoting EKI in two phases (cloudy_tpu.calibrate.
    run_sparse_eki):

    1. support identification: `n_iters` EKI updates, each followed by a
       soft threshold ``θ ← sign(θ)·max(|θ| − λ, 0)`` and a hard prune of
       entries below ``prune_below`` on the coordinates in ``sparse_idx``
       (default: all);
    2. debiasing polish: the support is frozen (coordinates whose ensemble
       mean was thresholded to exactly 0 stay 0), the ensemble is
       re-inflated around its mean, and ``polish_iters`` (default
       `n_iters`) plain EKI updates refit the active coefficients.

    Returns an `EKIResult` whose histories cover both phases."""
    theta0, y, gamma = _setup(theta0, y, noise_cov)
    n_ens, p = theta0.shape
    mask = torch.ones(p, dtype=theta0.dtype, device=theta0.device)
    if sparse_idx is not None:
        mask = torch.zeros_like(mask)
        mask[torch.as_tensor(sparse_idx, device=mask.device)] = 1.0
    factor = _noise_factor(gamma)
    n_polish = n_iters if polish_iters is None else polish_iters
    inflate = _normal(generator, (n_ens, p), theta0) if n_polish > 0 else None
    return _sparse_eki_loop(
        _batched(forward, transform), theta0, y, gamma,
        _etas(generator, factor, n_ens, n_iters), inflate,
        _etas(generator, factor, n_ens, n_polish), lambda_l1, prune_below, mask)


def _eks_update(theta, g, y, gamma, r0, gamma0, dt0: float, xi):
    """One EKS iteration given the draws ξ [J, P] ~ N(0, I) (the body of
    `cloudy_tpu.calibrate.run_eks`): explicit data drift with the
    Nüsken/Reich finite-ensemble correction, implicit prior drift, Langevin
    noise √(2Δt)·chol(C)·ξ."""
    n_ens, p = theta.shape
    eye_p = torch.eye(p, dtype=theta.dtype, device=theta.device)
    e = g - torch.mean(g, dim=0)[None, :]
    r = g - y[None, :]
    d_mat = (_solve(gamma, r.T).T @ e.T) / n_ens  # [J, J]
    dt = dt0 / (torch.linalg.norm(d_mat) + 1e-8)
    th_a = theta - torch.mean(theta, dim=0, keepdim=True)
    theta_star = theta - dt * d_mat @ theta + dt * ((p + 1) / n_ens) * th_a
    cov = th_a.T @ th_a / n_ens  # [P, P]
    cg0 = cov @ _solve(gamma0, eye_p)  # C Γ₀⁻¹
    lhs = eye_p + dt * cg0
    rhs = theta_star + dt * (cg0 @ r0)[None, :]
    theta_next = _solve(lhs, rhs.T).T
    chol = _cholesky(cov + 1e-12 * eye_p)
    return theta_next + torch.sqrt(2.0 * dt) * xi @ chol.T


def run_eks(
    forward: Callable,
    theta0,
    y,
    noise_cov,
    prior_mean,
    prior_cov,
    n_iters: int,
    generator: torch.Generator,
    dt0: float = 1.0,
    transform: Optional[Callable] = None,
) -> EKIResult:
    """Ensemble Kalman Sampler (the EKP.jl `Sampler` process): at
    equilibrium the ensemble samples the Bayesian posterior with prior
    N(``prior_mean``, ``prior_cov``). The adaptive step is
    ``dt0 / (‖D‖_F + 1e-8)``; for a calibrated posterior spread use
    ``dt0 ≲ 0.1`` (cloudy_tpu.calibrate.run_eks)."""
    theta0, y, gamma = _setup(theta0, y, noise_cov)
    n_ens, p = theta0.shape
    r0 = torch.broadcast_to(torch.as_tensor(prior_mean, dtype=theta0.dtype,
                                            device=theta0.device), (p,))
    gamma0 = _as_cov(prior_cov, p, theta0)
    xis = (_normal(generator, (n_ens, p), theta0) for _ in range(n_iters))
    return _eks_loop(_batched(forward, transform), theta0, y, gamma, r0, gamma0,
                     dt0, xis)


def _eks_loop(fwd, theta0, y, gamma, r0, gamma0, dt0, xis) -> EKIResult:
    """EKS iterations, one per draw ξ in `xis`."""
    misfit = _misfit_fn(y, gamma)
    update = lambda th, g, xi: _eks_update(th, g, y, gamma, r0, gamma0, dt0, xi)  # noqa: E731
    return _result(fwd, *_iterate(update, fwd, theta0, xis, misfit), misfit)


def run_uki(
    forward: Callable,
    prior_mean,
    prior_cov,
    y,
    noise_cov,
    n_iters: int,
    alpha_reg: float = 1.0,
    transform: Optional[Callable] = None,
    jitter: float = 1e-10,
) -> UKIResult:
    """Unscented Kalman Inversion (the EKP.jl `Unscented` process): each
    iteration evaluates the batched ``forward`` at the 2P symmetric cubature
    points m̂ ± √P·[chol(Ĉ)]_j and updates

        m̂ = r + α(m − r),   Ĉ = 2C
        m⁺ = m̂ + C_θg (C_gg + 2Γ)⁻¹ (y − ĝ),  C⁺ = Ĉ − C_θg (C_gg + 2Γ)⁻¹ C_θgᵀ

    (cloudy_tpu.calibrate.run_uki). Deterministic: no generator."""
    m0 = torch.atleast_1d(torch.as_tensor(prior_mean))
    p = m0.shape[0]
    c0 = torch.as_tensor(prior_cov, dtype=m0.dtype, device=m0.device)
    eye_p = torch.eye(p, dtype=m0.dtype, device=m0.device)
    if c0.ndim == 0:
        c0 = c0 * eye_p
    elif c0.ndim == 1:
        c0 = torch.diag(c0)
    y = torch.as_tensor(y, dtype=m0.dtype, device=m0.device)
    gamma = _as_cov(noise_cov, y.shape[0], m0)
    misfit = _misfit_fn(y, gamma)
    fwd = _batched(forward, transform)
    sqrt_p = float(p) ** 0.5

    m, c = m0, c0
    m_hist, c_hist, mf_hist = [], [], []
    for _ in range(n_iters):
        m_hat = m0 + alpha_reg * (m - m0)
        c_hat = 2.0 * c  # α²C + (2 − α²)C
        chol = _cholesky(0.5 * (c_hat + c_hat.T) + jitter * eye_p)
        dev = sqrt_p * chol.T  # rows: √P · columns of chol
        pts = torch.cat([m_hat[None, :] + dev, m_hat[None, :] - dev])  # [2P, P]
        g = fwd(pts)  # [2P, D]
        g_mean = torch.mean(g, dim=0)
        th_a = pts - m_hat[None, :]
        g_a = g - g_mean[None, :]
        c_thg = th_a.T @ g_a / (2 * p)
        c_gg = g_a.T @ g_a / (2 * p) + 2.0 * gamma  # Σ_ν = 2Γ
        kal = _solve_pos(c_gg, c_thg.T).T  # [P, D]
        m_hist.append(m)
        c_hist.append(c)
        mf_hist.append(misfit(g_mean))
        m = m_hat + kal @ (y - g_mean)
        c = c_hat - kal @ c_thg.T
        c = 0.5 * (c + c.T)
    mf_hist.append(misfit(fwd(m[None])[0]))
    return UKIResult(m, c, torch.stack(m_hist + [m]), torch.stack(c_hist + [c]),
                     torch.stack(mf_hist))


def fit_gradient(
    loss: Callable,
    params0,
    n_iters: int,
    optimizer: Optional[Callable] = None,
    learning_rate: float = 1e-2,
) -> GradFitResult:
    """Minimise ``loss(params)`` by autograd and an optimizer:
    ``optimizer(params_list) -> torch.optim.Optimizer`` (default
    ``torch.optim.Adam(params_list, lr=learning_rate)``, the update of
    `optax.adam`). The loss history is one tensor, read by the caller; no
    iteration reads a value on the host."""
    params = torch.as_tensor(params0).detach().clone().requires_grad_(True)
    opt = (optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate)))([params])
    hist = []
    for _ in range(n_iters):
        opt.zero_grad()
        value = loss(params)
        value.backward()
        opt.step()
        hist.append(value.detach())
    return GradFitResult(params.detach(), torch.stack(hist))
