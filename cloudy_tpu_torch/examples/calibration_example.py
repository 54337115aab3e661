"""Kernel calibration from noisy observations: EKI, EKS, UKI and gradient
descent, then sparse EKI over every kernel-tensor coefficient.

Port of examples/calibration_example.py (no reference counterpart: CliMA
calibrates Cloudy.jl externally through EnsembleKalmanProcesses.jl). The
forward is a single gamma box under the Golovin tensor, its coalescence
rate scaled by s, observed as LOG-moments at three times; every ensemble
member is one row of a batched forward through torch ops (`calibrate`
takes ``forward(theta [J, P]) -> [J, D]``), in f64 on `--device`. Where
the JAX script splits PRNG keys, this one draws from explicit
`torch.Generator`s seeded on the device: the two give other numbers, so
the recovered values agree in what they recover, not digit for digit.
"""

import time

import numpy as np
import torch

from cloudy_tpu_torch import calibrate, distributions as pd, stepper
from cloudy_tpu_torch.coalescence import (build_coalescence_data, get_coal_ints,
                                          make_kernel_diff_coal_fn)
from cloudy_tpu_torch.examples.common import DTYPE, Family, K, SpectrumSpec, fast, parse_args

S_TRUE, NOISE = 1.7, 1e-3


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_forward(device="cuda"):
    """(forward, data, mom0): the batched forward ``log s [J, 1] -> [J, 9]``
    of the Golovin box, LOG-moments at three times per member (the moments
    span ~9 decades over the prior's s-range, so log space keeps the
    Kalman solves well conditioned), its coalescence data and its start."""
    spec = SpectrumSpec((Family.GAMMA,))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=(1e6, 1e-9))
    mom0 = torch.tensor([1e2, 1e1, 2.0], dtype=DTYPE, device=device)
    obs_idx = torch.tensor([5, 10, 15], device=device)

    def forward(log_s):
        s = torch.exp(log_s[:, 0])

        def rhs(m, t):
            del t
            return s[:, None] * get_coal_ints(data, pd.params_from_moments(spec, m))

        y0 = mom0.expand(log_s.shape[0], -1)
        _, ys = stepper.integrate(rhs, y0, 0.0, 2.0, 15, method="ssprk33")
        return torch.log(ys[obs_idx]).transpose(0, 1).reshape(log_s.shape[0], -1)

    return forward, data, mom0


def main(argv=None):
    args = parse_args(argv, __doc__)
    dev = args["device"]
    t0 = time.perf_counter()
    quick = fast()
    spec = SpectrumSpec((Family.GAMMA,))
    forward, data, mom0 = make_forward(dev)

    g_obs, g_ens, g_run = (_gen(dev, s) for s in (0, 1, 2))
    y = forward(torch.full((1, 1), float(np.log(S_TRUE)), dtype=DTYPE, device=dev))[0]
    y = y + NOISE * torch.randn(y.shape, generator=g_obs, dtype=DTYPE, device=dev)

    # ---- EKI: a 24-member ensemble
    theta0 = calibrate.ensemble_init(g_ens, [0.0], [0.7], n_ens=24, dtype=DTYPE)
    res = calibrate.run_eki(forward, theta0, y, NOISE ** 2, 3 if quick else 6, g_run)
    s_eki = float(torch.exp(res.theta[:, 0].mean()))
    print(f"EKI:      s = {s_eki:.4f} (truth {S_TRUE}); "
          f"misfit {float(res.misfit_history[0]):.3g} -> {float(res.misfit_history[-1]):.3g}")

    # ---- EKS: posterior samples (the ensemble keeps its spread)
    res_s = calibrate.run_eks(forward, theta0, y, NOISE ** 2, [0.0], [0.7 ** 2],
                              10 if quick else 30, _gen(dev, 3))
    s_eks = float(torch.exp(res_s.theta[:, 0].mean()))
    print(f"EKS:      s = {s_eks:.4f} (truth {S_TRUE}); ensemble std(log s) = "
          f"{float(torch.std(res_s.theta[:, 0], correction=0)):.2e}; "
          f"misfit {float(res_s.misfit_history[0]):.3g} -> "
          f"{float(res_s.misfit_history[-1]):.3g}")

    # ---- UKI: deterministic sigma points; the converged covariance is the
    # posterior uncertainty of log s
    res_u = calibrate.run_uki(forward, torch.tensor([0.0], dtype=DTYPE, device=dev),
                              torch.tensor([[0.7 ** 2]], dtype=DTYPE, device=dev), y,
                              NOISE ** 2, 4 if quick else 8)
    s_uki = float(torch.exp(res_u.mean[0]))
    print(f"UKI:      s = {s_uki:.4f} (truth {S_TRUE}); posterior std(log s) = "
          f"{float(torch.sqrt(res_u.cov[0, 0])):.2e}; misfit "
          f"{float(res_u.misfit_history[0]):.3g} -> {float(res_u.misfit_history[-1]):.3g}")

    # ---- gradient descent through the whole differentiable model
    res_g = calibrate.fit_gradient(
        lambda t: torch.sum((forward(t.reshape(1, 1))[0] - y) ** 2),
        torch.tensor(0.0, dtype=DTYPE, device=dev), 40 if quick else 120, learning_rate=0.1)
    s_grad = float(torch.exp(res_g.params))
    print(f"gradient: s = {s_grad:.4f} (truth {S_TRUE}); loss "
          f"{float(res_g.loss_history[0]):.3g} -> {float(res_g.loss_history[-1]):.3g}")
    print("done")

    # ---- sparse EKI over ALL kernel-tensor coefficients: recover a pure
    # Golovin kernel (only c[0,1] = c[1,0] active) from noisy box
    # trajectories, with exact zeros on the inactive coefficients (hard
    # prune) and a debiasing polish on the survivors
    kfn = make_kernel_diff_coal_fn(data)
    k_true = torch.tensor(data.kernels, dtype=DTYPE, device=dev).reshape(-1)
    b_n = float(k_true[1])

    def member(kflat):
        def rhs(m, t):
            del t
            return kfn(pd.params_from_moments(spec, m), kflat.reshape(1, 1, 2, 2))

        _, ys = stepper.integrate(rhs, mom0, 0.0, 0.5, 60, save_every=12)
        safe = torch.clamp(torch.nan_to_num(ys[1:], nan=1e12, posinf=1e12), 1e-12, 1e12)
        return torch.log(safe).reshape(-1)

    forward_tensor = torch.func.vmap(member)
    y_t = forward_tensor(k_true[None])[0]
    y_t = y_t + 1e-3 * torch.randn(y_t.shape, generator=_gen(dev, 7), dtype=DTYPE, device=dev)
    theta_t = calibrate.ensemble_init(_gen(dev, 8), torch.zeros(4, dtype=DTYPE),
                                      b_n * torch.ones(4, dtype=DTYPE), n_ens=40, dtype=DTYPE)
    res_sp = calibrate.run_sparse_eki(
        forward_tensor, theta_t, y_t, 1e-6, 5 if quick else 10, _gen(dev, 9),
        lambda_l1=0.05 * b_n, prune_below=0.2 * b_n, polish_iters=5 if quick else 10)
    m_sp = res_sp.theta.mean(0).reshape(2, 2).cpu().numpy()
    print(f"sparse EKI kernel tensor (truth c01=c10={b_n:.3g}, c00=c11=0):")
    print(f"  recovered c = {m_sp.tolist()}")
    print(f"  exact zeros: c00={m_sp[0, 0] == 0.0} c11={m_sp[1, 1] == 0.0}; "
          f"active total {m_sp[0, 1] + m_sp[1, 0]:.4g} vs {2 * b_n:.4g}")
    seconds = time.perf_counter() - t0
    print(f"calibration example host seconds {seconds:.3f} on {dev}")
    return {"s_eki": s_eki, "s_eks": s_eks, "s_uki": s_uki, "s_grad": s_grad,
            "sparse": m_sp, "b_n": b_n, "seconds": seconds}


if __name__ == "__main__":
    main()
