"""JAX's outputs for configurations the prebuilt kernels do not hold, stored
for the card: the four-gamma-mode spectrum of
examples/box_gamma_mixture_4modes.py through the Pallas coalescence RHS,
fused RHS and whole step at the fast tier (interpret mode), its reference
tier through JAX's XLA path, the Pallas quadrature kernel (B5) at four
modes, and the Pallas scaled whole step (`fn_scaled`) at the reference
tier, all in f64 on the CPU, with their inputs.

tests/test_torch_cuda_kernels.py holds the card's kernels against the
stored arrays (it imports no jax, so it runs where jax is absent), and
tests/test_torch_four_modes.py holds the port's twins against JAX live
and this file's output against a fresh JAX call. The input functions here
are those tests' own.

Regenerate (~1.5 min on one CPU core):

    JAX_PLATFORMS=cpu python tests/_four_modes_reference.py
"""

from __future__ import annotations

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_torch",
                    "four_modes.npz")

NORMS = (1e6, 1e-9)
VEL = ((50.0, 1.0 / 6.0),)
THR4 = (5e-10, 5e-9, 5e-8, np.inf)
THR2 = (5e-10, np.inf)
NZ = 8
DZ = 3000.0 / NZ
#: per mode: number, mean mass (k = 1 gamma: M2 = 2 N x^2), each mode's mean
#: below its threshold
AMPS = [(1e8 * 10.0 ** -j, 1e-10 * 10.0 ** j) for j in range(4)]
#: B5's node budgets at four modes (the interpreter's trace stays short)
NUM_NODES = dict(n_outer=16, n_inner=8)
#: series/CF iterations of the scaled reference step (an interpret-mode
#: reference whole step traces ~28 s at the default 128)
SCALED_REF_ITERS = 32


def data(n_modes=4, fast=True, tensor_scale=1.0):
    """(JAX data, port data): gamma modes (four: THR4; two: THR2), Golovin
    5.0 at order 1 scaled by `tensor_scale`, norms NORMS."""
    from cloudy_tpu import kernels as JK
    from cloudy_tpu.coalescence import build_coalescence_data as jbuild
    from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    thr = THR4 if n_modes == 4 else THR2
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    if tensor_scale != 1.0:
        jker = JK.CoalescenceTensor(tensor_scale * jker.array)
        ker = K.CoalescenceTensor(tensor_scale * ker.array)
    jd = jbuild(JSpec((JF.GAMMA,) * n_modes), jker, thr, norms=NORMS, fast_tier=fast)
    td = build_coalescence_data(SpectrumSpec((Family.GAMMA,) * n_modes), ker, thr,
                                norms=NORMS, fast_tier=fast)
    return jd, td


def moments(B, seed, n_modes=4):
    """Normalized gamma moments [3 n_modes, B] from parameters drawn first:
    n ∈ [10, 200], θ ∈ [0.05, 5], k ∈ [0.5, 5] per mode
    (tests/test_pallas.py:22-35), in closed form (M0 = n, M1 = n k θ,
    M2 = n k (k + 1) θ²); box 3 empty."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_modes):
        n, theta, k = rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B), rng.uniform(0.5, 5.0, B)
        rows += [n, n * k * theta, n * k * (k + 1.0) * theta * theta]
    mom = np.stack(rows)
    mom[:, 3] = 0.0
    return mom


def state(n_cols, seed, n_modes=4, defects=True):
    """A physical state [3 n_modes, n_cols · NZ] (SoA, z contiguous in a
    column): each mode's top hat (`models.rainshaft.initial_condition`) at
    a seeded amplitude per column and mode;
    with `defects`, one negative moment and one level of small negative
    ones."""
    from cloudy_tpu_torch.models.rainshaft import initial_condition

    z = (np.arange(NZ) + 0.5) * DZ
    ic = np.concatenate([initial_condition(z, [n, n * x, 2.0 * n * x * x])
                         for n, x in AMPS[:n_modes]], axis=-1)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, n_modes)).repeat(3, axis=2)
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    if defects:
        st[0, NZ // 2, 0] *= -1.0
        st[1, NZ // 2 + 1, 3:6] = -1e-3
    return np.ascontiguousarray(np.moveaxis(st, -1, 0).reshape(3 * n_modes, -1))


def compute() -> dict:
    """Every stored array: inputs and JAX's outputs, f64."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from cloudy_tpu import kernels as JK
    from cloudy_tpu import stepper as jstepper
    from cloudy_tpu.coalescence import make_coal_rhs
    from cloudy_tpu.models import rainshaft as jrs
    from cloudy_tpu.ops import pallas_coalescence as pc
    from cloudy_tpu.ops import pallas_numerical as pn
    from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec
    from cloudy_tpu.spec import get_moments_normalizing_factors

    out = {}
    jd, _ = data()
    out["coal_mom"] = moments(64, seed=1)
    out["coal_fast"] = np.asarray(pc.make_pallas_coal_fn(jd, block_cols=64, interpret=True)
                                  .soa(jnp.asarray(out["coal_mom"])))
    out["state"] = state(4, seed=0)
    out["rhs_fast"] = np.asarray(pc.make_pallas_rainshaft_rhs_fn(
        jd, VEL, NORMS, block_cols=32, interpret=True).soa(jnp.asarray(out["state"])))
    out["step_fast"] = np.asarray(pc.make_pallas_rainshaft_step_fn(
        jd, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, block_cols=32, interpret=True)(
            jnp.asarray(out["state"])))
    jr, _ = data(fast=False)
    norm = np.asarray(get_moments_normalizing_factors((3,) * 4, NORMS))
    out["coal_ref_phys"] = np.asarray(jax.jit(make_coal_rhs(jr, NORMS))(
        jnp.asarray((out["coal_mom"] * norm[:, None]).T))).T
    config = jrs.RainshaftConfig(spec=jr.spec, nz=NZ, zmax=3000.0, norms=NORMS)
    st = np.moveaxis(out["state"].reshape(12, -1, NZ), 0, -1)
    step = np.asarray(jstepper.ssprk33_step(jax.jit(jrs.make_rainshaft_rhs(config, jr)),
                                            jnp.asarray(st), 0.0, 1.0))
    out["step_ref"] = np.ascontiguousarray(np.moveaxis(step, -1, 0).reshape(12, -1))
    out["num_mom"] = moments(64, seed=2)
    kf = JK.LinearKernelFunction(5.0).normalized(NORMS)
    out["num"] = np.asarray(pn.make_pallas_numerical_fn(
        JSpec((JF.GAMMA,) * 4), kf, **NUM_NODES, block_cols=64, interpret=True)(
            jnp.asarray(out["num_mom"].T.copy()))).T
    j2, _ = data(n_modes=2, fast=False)
    out["scaled_state"] = state(4, seed=5, n_modes=2, defects=False)
    out["scale"] = np.repeat(np.linspace(0.4, 2.5, 4), NZ)
    out["scaled_ref"] = np.asarray(pc.make_pallas_rainshaft_step_fn(
        j2, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, block_cols=32, interpret=True, kernel_scale=True,
        gammainc_iters=SCALED_REF_ITERS)(jnp.asarray(out["scaled_state"]),
                                         jnp.asarray(out["scale"])[None]))
    return out


def load() -> dict:
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


def main():
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **compute())
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
