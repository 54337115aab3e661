"""The port's box model and box scenarios on the CPU.

The three box scenarios of the port's harness run in f64 on the CPU and are
held against the stored f64 trajectories of the JAX package
(tests/golden/box_*.npz) at rtol 1e-6; the Golovin helpers are held against
the JAX package's own at 1e-12 (both are numpy/scipy on the host).
"""

import json

import numpy as np
import pytest
import torch

from cloudy_tpu.models import box as jbox

from cloudy_tpu_torch import harness
from cloudy_tpu_torch.models import box
from cloudy_tpu_torch.spec import Family, SpectrumSpec

from _golden_cases import load_golden

torch.set_num_threads(1)

BOX_SCENARIOS = ["box_single_gamma_golovin", "box_exp_gamma_mixture",
                 "box_long_numerical"]


@pytest.mark.parametrize("name", BOX_SCENARIOS)
def test_box_scenario_matches_golden(name, tmp_path):
    ts_g, ys_g = load_golden(name)
    ys, report = harness.run_scenario(name, device="cpu", outdir=str(tmp_path))
    assert ys.dtype == torch.float64 and tuple(ys.shape) == ys_g.shape
    np.testing.assert_allclose(ys.numpy(), ys_g, rtol=1e-6)
    sc = harness.SCENARIOS[name](device="cpu")
    assert sc["kind"] == "box"
    if name == "box_single_gamma_golovin":  # the cheap one: the saved times too
        ts, _ = box.run_box(sc["config"], sc["rhs"], sc["state0"])
        np.testing.assert_allclose(ts.numpy(), ts_g, rtol=1e-14)
        assert sc["run"]()[2] == "host"
    assert report["scenario"] == name and report["device"] == "cpu"
    assert report["dtype"] == "float64" and report["finite"]
    assert report["n_steps"] == len(ts_g) - 1
    assert report["negative_fraction"] == 0.0 and report["nonfinite_fraction"] == 0.0
    # coalescence conserves the total mass and lowers the total number
    m1 = sum(ys[:, sc["spec"].dist_moment_ind(i, 1)] for i in range(sc["spec"].n_modes))
    assert float((m1 / m1[0] - 1.0).abs().max()) < 1e-3
    logged = [json.loads(ln) for ln in (tmp_path / "runs.jsonl").read_text().splitlines()]
    assert logged == [report]


def test_box_scenario_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run_scenario("box_long_numerical", device="cuda")


def test_cli_runs_a_box_scenario(capsys):
    harness.main(["box_single_gamma_golovin", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["scenario"] == "box_single_gamma_golovin" and report["finite"]
    with pytest.raises(SystemExit):
        harness.main(["box_single_gamma_golovin"])  # --device is required


@pytest.mark.parametrize("t", [0.0, 10.0, 120.0])
def test_golovin_helpers_match_jax_package(t):
    got = box.golovin_moments(1e-10, t, b=5.0, n=1e8)
    want = jbox.golovin_moments(1e-10, t, b=5.0, n=1e8)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    x = np.geomspace(1e-13, 1e-8, 50)
    np.testing.assert_allclose(
        box.golovin_analytical_solution(x, 1e-10, t, b=5.0, n=1e8),
        jbox.golovin_analytical_solution(x, 1e-10, t, b=5.0, n=1e8), rtol=1e-12)


def test_box_rhs_numerical_matches_jax_package():
    """One RHS evaluation of the numerical box on the golden's initial
    state, against the JAX package's (rtol 1e-9: einsum orders differ)."""
    import jax.numpy as jnp
    from cloudy_tpu import kernels as JK
    from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec
    from cloudy_tpu_torch import kernels as K

    mom0 = [1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13]
    jcfg = jbox.BoxConfig(spec=JSpec((JFamily.GAMMA, JFamily.GAMMA)), t_end=60.0, dt=2.0)
    want = np.asarray(jbox.make_box_rhs(
        jcfg, kernel_func=JK.LongKernelFunction(5.236e-10, 9.44e9, 5.78),
        numerical=True)(jnp.asarray(mom0), 0.0))
    cfg = box.BoxConfig(spec=SpectrumSpec((Family.GAMMA, Family.GAMMA)), t_end=60.0, dt=2.0)
    got = box.make_box_rhs(
        cfg, kernel_func=K.LongKernelFunction(5.236e-10, 9.44e9, 5.78),
        numerical=True)(torch.tensor(mom0, dtype=torch.float64), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


def test_condensation_box_waits_for_its_module():
    cfg = box.BoxConfig(spec=SpectrumSpec((Family.GAMMA,)))
    with pytest.raises(NotImplementedError, match="A.9"):
        box.make_box_condensation_rhs(cfg, 0.01, 1e-2)


def test_scenarios_are_routed_by_kind_not_by_name(monkeypatch):
    """A box registered under a name of another shape runs as a box: the
    scenario's own `kind` routes it."""
    monkeypatch.setitem(harness.SCENARIOS, "single_gamma",
                        harness.SCENARIOS["box_single_gamma_golovin"])
    ys, report = harness.run_scenario("single_gamma", device="cpu")
    assert ys.shape == (121, 3) and report["finite"] and "n_columns" not in report
    with pytest.raises(TypeError):
        harness.run_scenario("single_gamma", device="cpu", n_columns=8)
    assert harness.SCENARIOS["pod_ensemble"](n_columns=1, device="cpu")["kind"] == "ensemble"
