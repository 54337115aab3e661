"""The port package stands alone: it imports without jax, its kernel wrappers
run the plain twin only for CPU tensors (counting no launch), and they refuse
inputs and configurations the CUDA kernels do not take."""

import subprocess
import sys
import os

import numpy as np
import pytest
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.ops import fused_coalescence as fc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMS = (1e6, 1e-9)


def _data(families=(Family.GAMMA, Family.GAMMA), thresholds=(5e-10, np.inf), **kw):
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    kw.setdefault("fast_tier", True)
    return build_coalescence_data(SpectrumSpec(families), ker, thresholds,
                                  norms=NORMS, **kw)


def _port_modules():
    """Every module of the port, by dotted name."""
    import pkgutil

    import cloudy_tpu_torch

    return ["cloudy_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(cloudy_tpu_torch.__path__, "cloudy_tpu_torch."))


def test_import_without_jax():
    """Every module of the port imports in a process where importing jax or
    cloudy_tpu fails."""
    modules = _port_modules()
    assert {"cloudy_tpu_torch.models.rainshaft", "cloudy_tpu_torch.ops.fused_coalescence",
            "cloudy_tpu_torch.harness", "cloudy_tpu_torch.bench",
            "cloudy_tpu_torch.coalescence",
            "cloudy_tpu_torch.tools.whole_step_ablation",
            "cloudy_tpu_torch.ops.op_chains",
            "cloudy_tpu_torch.tools.op_microbench",
            "cloudy_tpu_torch.utils.checkpoint", "cloudy_tpu_torch.utils.io",
            "cloudy_tpu_torch.utils.metrics",
            "cloudy_tpu_torch.tools.longhorizon",
            "cloudy_tpu_torch.native", "cloudy_tpu_torch.utils.plotting",
            "cloudy_tpu_torch.ops.kernel_expr", "cloudy_tpu_torch.tools.whole_step_1m",
            "cloudy_tpu_torch.examples.common",
            "cloudy_tpu_torch.examples.calibration_example",
            "cloudy_tpu_torch.examples.parcel_example"} <= set(modules)
    from cloudy_tpu_torch.examples import EXAMPLES

    assert {f"cloudy_tpu_torch.examples.{n}" for n in EXAMPLES} <= set(modules)
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'cloudy_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(m.split('.')[0] in ('jax', 'cloudy_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_source_line_imports_jax_or_the_jax_package():
    """No module of the port, and not chip_smoke.py, names jax or cloudy_tpu
    in an import statement."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|cloudy_tpu)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for folder, _, names in os.walk(os.path.join(ROOT, "cloudy_tpu_torch")):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            bad = [ln for ln in f if pattern.match(ln)]
        assert not bad, (path, bad)


def test_entry_points_default_to_the_card():
    """No public `run_*` or `make_*` function of the port, nor a scenario
    builder, defaults to the CPU: a caller asks for the host (the JAX entry
    points run on the default backend)."""
    import importlib
    import inspect

    checked = []
    for name in _port_modules():
        module = importlib.import_module(name)
        for fname, fn in inspect.getmembers(module, inspect.isfunction):
            if fn.__module__ != name or not (
                    fname.startswith(("run_", "make_", "_scenario_"))):
                continue
            param = inspect.signature(fn).parameters.get("device")
            if param is None:
                continue
            checked.append(f"{name}.{fname}")
            assert param.default is not inspect.Parameter.empty, (name, fname)
            assert torch.device(param.default).type == "cuda", (name, fname, param.default)
    assert "cloudy_tpu_torch.models.rainshaft.run_rainshaft" in checked
    assert "cloudy_tpu_torch.harness.run_scenario" in checked
    assert "cloudy_tpu_torch.harness._scenario_rainshaft_128" in checked
    assert "cloudy_tpu_torch.ops.fused_coalescence.make_coal_fn" in checked


def test_cpu_tensor_runs_twin_without_launch():
    data = _data()
    coal = fc.make_coal_fn(data, device="cpu", dtype=torch.float64)
    mom = torch.rand(6, 64, dtype=torch.float64) + 0.5
    np.testing.assert_array_equal(coal.soa(mom).numpy(),
                                  fc.coal_soa_plain(mom, coal.plan).numpy())
    assert coal(mom.T).shape == (64, 6)
    step = fc.make_rainshaft_step_fn(data, ((50.0, 1.0 / 6.0),), NORMS, nz=16,
                                     dz=100.0, dt=1.0, device="cpu",
                                     dtype=torch.float64)
    state = torch.rand(6, 64, dtype=torch.float64)
    np.testing.assert_array_equal(step(state).numpy(), step.plain(state).numpy())
    scaled = fc.make_rainshaft_step_fn(data, ((50.0, 1.0 / 6.0),), NORMS, nz=16,
                                       dz=100.0, dt=1.0, device="cpu",
                                       dtype=torch.float64, kernel_scale=True)
    np.testing.assert_array_equal(scaled(state, 1.5).numpy(),
                                  scaled.plain(state, 1.5).numpy())
    np.testing.assert_array_equal(scaled(state, 1.0).numpy(), step(state).numpy())
    assert coal.launches == 0 and step.launches == 0 and scaled.launches == 0


def test_step_rejects_partial_columns():
    step = fc.make_rainshaft_step_fn(_data(), ((50.0, 1.0 / 6.0),), NORMS, nz=16,
                                     dz=100.0, dt=1.0, device="cpu",
                                     dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of nz"):
        step(torch.zeros(6, 40))


def test_wrapper_rejects_wrong_dtype_shape_layout():
    coal = fc.make_coal_fn(_data(), device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="float64"):
        coal.soa(torch.zeros(6, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="n_tot"):
        coal.soa(torch.zeros(5, 8))
    with pytest.raises(ValueError, match="contiguous"):
        coal.soa(torch.zeros(8, 6).T)


@pytest.mark.parametrize(
    "case",
    ["capacity"],
)
def test_unsupported_configuration_raises(case):
    """Configurations past the prebuilt kernels' capacities (four gamma
    modes: 4 modes, n_tot 12) no longer raise: the generated kernels are
    sized from the plan at either tier, and the table-driven reference
    instances (the yardstick, `_table`) run units built at their own
    capacities (`plan_caps`). What still raises is the private table-driven
    fast yardstick at such a plan (it exists at the prebuilt capacities
    only)."""
    data = _data((Family.GAMMA,) * 4, (5e-10,) * 3 + (np.inf,))
    coal = fc.make_coal_fn(data, device="cpu")
    step = fc.make_rainshaft_step_fn(data, ((50.0, 1.0 / 6.0),), NORMS, nz=32,
                                     dz=93.75, dt=1.0, device="cpu")
    assert coal.route == step.route == "generated" and step.plan.n_tot == 12
    assert fc.plan_caps(step.plan) == (4, 12, 5) != fc.CAPS
    with pytest.raises(ValueError, match="prebuilt capacities"):
        fc.RainshaftStepFn(step.plan, "cpu", torch.float32, _table=True)
    ref = _data((Family.GAMMA,) * 4, (5e-10,) * 3 + (np.inf,), fast_tier=False)
    ref_step = fc.make_rainshaft_step_fn(ref, ((50.0, 1.0 / 6.0),), NORMS, nz=32,
                                         dz=93.75, dt=1.0, device="cpu")
    assert ref_step.route == "generated" and ref_step.unit.n_tot == 12
    ref_table = fc.RainshaftStepFn(ref_step.plan, "cpu", torch.float32, _table=True)
    assert ref_table.route == "table" and ref_table.caps == (4, 12, 5)
    assert [u.kind for u in ref_table.build_units()] == ["ref_step"]


@pytest.mark.parametrize(
    "case",
    ["moving_newton", "simpson_tier", "gauss_grid", "exact_series", "exp_gamma_simpson",
     "moving_gauss_gl", "lognormal_window_series", "lognormal", "monodisperse"],
)
def test_reference_tier_configuration_accepted(case):
    """Gamma and exponential modes at quad_rule "reference" and "gauss",
    f2_exact True and False, gammainc_gl_nodes 0 and > 0, fixed and moving,
    a thresholded lognormal mode on the Φ grid (B-arms.4) and a monodisperse
    mode (B-arms.3, here at the fast tier's switches) build and select the
    kernels' reference-tier instance."""
    kw = {}
    if case == "lognormal":
        data = _data((Family.LOGNORMAL, Family.GAMMA), lognorm_gl_nodes=0)
    elif case == "monodisperse":
        data = _data((Family.MONODISPERSE, Family.GAMMA))
    elif case == "moving_newton":
        data = _data(thresholds=(0.9, 1.0), moving=True, gammainc_gl_nodes=0)
    elif case == "simpson_tier":
        data = _data(fast_tier=False)
    elif case == "gauss_grid":
        data, kw = _data(fast_tier=False), {"quad_rule": "gauss", "gammainc_gl_nodes": 12}
    elif case == "exact_series":
        data = _data(fast_tier=False, f2_exact=True)
    elif case == "exp_gamma_simpson":
        data = _data((Family.EXPONENTIAL, Family.GAMMA), fast_tier=False)
    elif case == "moving_gauss_gl":
        data, kw = _data(thresholds=(0.9, 1.0), moving=True), {"quad_rule": "gauss",
                                                             "f2_exact": False}
    else:
        data = _data((Family.LOGNORMAL, Family.GAMMA), gammainc_gl_nodes=0)
    coal = fc.make_coal_fn(data, device="cpu", **kw)
    step = fc.make_rainshaft_step_fn(data, ((50.0, 1.0 / 6.0),), NORMS, nz=32,
                                     dz=93.75, dt=1.0, device="cpu", **kw)
    for fn in (coal, step):
        assert fn.plan.ref and fn.plan.instance == 2
        assert fc.pack_config(fn.plan, torch.float64).size <= 12288  # within 12 KB
    from cloudy_tpu_torch import distributions as pd

    params = torch.tensor([[100.0, 0.5, 2.0], [10.0, 2.0, 3.0]]).expand(16, 2, 3)
    mom = pd.get_moments(data.spec, params).T.contiguous()
    assert bool(torch.isfinite(coal.soa(mom)).all())


def test_packed_config_reference_tier():
    """The reference tier's header slots, per-mode F2 kinds and grid
    lengths, and the tail of reals (grid dx, moving Gauss base nodes, the
    fixed grids' nodes and weights) sit where csrc/coal_body.cuh reads them;
    a three-mode configuration with two Simpson grids fits the buffer."""
    plan = fc.build_plan(_data(fast_tier=False, gammainc_iters=40),
                         ((50.0, 1.0 / 6.0),), NORMS, nz=32, dz=93.75, dt=1.0,
                         thr_newton_iters=7)
    buf = fc.pack_config(plan, torch.float64)
    ints = buf.view(np.int32)
    assert list(ints[:4]) == [2, 6, 4, 0]  # series/CF: no GL nodes
    assert list(ints[10:16]) == [0, 40, 7, 128, plan.n_points_max, 0]
    assert list(ints[16:22]) == [fc.F2_GRID, fc.F2_NONE, 0, 76, 0, 0]
    reals = buf[int(ints[7]):].view(np.float64)
    h = fc.MAX_MODES + 2 * fc.MAX_NTOT + len(plan.wb_nz) + len(plan.wf_nz) + 3 * 3
    assert list(reals[h:h + 3]) == [1.0, 1.0 / 93.75, 2.0 / 3.0]  # dt, inv_dz, 2/3
    x, w, dx = fc._static_grid(0.5)
    assert reals[h + 3] == dx and list(reals[h + 4:h + 6]) == [0.0, 0.0]
    np.testing.assert_array_equal(reals[h + 6:h + 6 + 76], x)
    np.testing.assert_array_equal(reals[h + 6 + 76:h + 6 + 152], w)
    assert w[-1] == 0.0  # the masked last point
    # MovingThreshold "gauss": the GL base nodes, rounded once to the type
    plan = fc.build_plan(_data(thresholds=(0.9, 1.0), moving=True, fast_tier=False),
                         quad_rule="gauss", gauss_nodes=16)
    buf = fc.pack_config(plan, torch.float32)
    ints = buf.view(np.int32)
    assert list(ints[14:20]) == [128, 16, fc.F2_GRID, fc.F2_NONE, 0, 0]
    reals = buf[int(ints[7]):].view(np.float32)
    u, _ = np.polynomial.legendre.leggauss(16)
    n_before = (fc.MAX_MODES + 2 * fc.MAX_NTOT + len(plan.wb_nz) + len(plan.wf_nz)
                + 3 + fc.MAX_MODES)
    np.testing.assert_array_equal(reals[n_before:n_before + 16], u.astype(np.float32))
    # three modes, Simpson grids of 76 and 86 points: the bytes the buffer needs
    three = fc.build_plan(_data((Family.GAMMA,) * 3, (5e-10, 5e-9, np.inf), fast_tier=False))
    assert [len(g[0]) if g else 0 for g in three.grids] == [76, 86, 0]
    assert fc.pack_config(three, torch.float64).size <= 12288  # within 12 KB


def test_cpu_tensor_runs_twin_without_launch_reference_tier():
    """The reference tier's wrappers on CPU tensors run their twins and
    count no launch, as the fast tier's do."""
    data = _data(fast_tier=False)
    coal = fc.make_coal_fn(data, device="cpu", dtype=torch.float64)
    mom = torch.rand(6, 64, dtype=torch.float64) + 0.5
    np.testing.assert_array_equal(coal.soa(mom).numpy(),
                                  fc.coal_soa_plain(mom, coal.plan).numpy())
    step = fc.make_rainshaft_step_fn(data, ((50.0, 1.0 / 6.0),), NORMS, nz=16,
                                     dz=100.0, dt=1.0, device="cpu", dtype=torch.float64)
    state = torch.rand(6, 64, dtype=torch.float64)
    np.testing.assert_array_equal(step(state).numpy(), step.plain(state).numpy())
    assert coal.launches == 0 and step.launches == 0


def test_packed_config_layout():
    """The byte buffer's header, per-mode ints, index tables and reals sit
    where csrc/coal_body.cuh reads them."""
    plan = fc.build_plan(_data(), ((50.0, 1.0 / 6.0),), NORMS, nz=32,
                         dz=93.75, dt=1.0)
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        buf = fc.pack_config(plan, dtype)
        assert buf.size % 16 == 0 and buf.size <= 12288  # within 12 KB
        ints = buf.view(np.int32)
        assert list(ints[:7]) == [2, 6, 4, 12, len(plan.wb_nz),
                                  len(plan.wf_nz), 1]
        assert list(ints[8:10]) == [0, 0]  # FixedThreshold, no window mode
        h, m = fc.HEADER_INTS, fc.MAX_MODES
        assert list(ints[h:h + 4 * m]) == [1, 1, 0, 0, 3, 0, 3, 3, 0, 1, 0, 0]
        tables = h + 4 * m
        assert list(ints[tables:tables + 3]) == list(plan.wb_nz[0][:3])
        n_int = tables + 3 * len(plan.wb_nz) + 4 * len(plan.wf_nz)
        assert list(ints[n_int - 4:n_int]) == list(plan.wf_nz[-1][:4])
        off = int(ints[7])
        assert off == 4 * (n_int + n_int % 2)
        real_t = np.float32 if size == 4 else np.float64
        reals = buf[off:].view(real_t)
        n_reals = (fc.MAX_MODES + 2 * fc.MAX_NTOT + len(plan.wb_nz)
                   + len(plan.wf_nz) + 3 + 3 + 3 + 2 * 12 + 3)
        assert reals[n_reals - 3] == real_t(1.0)  # dt
        assert reals[n_reals - 2] == real_t(1.0 / 93.75)  # inv_dz, host double
        assert reals[0] == real_t(0.5)  # normalized threshold of mode 0


@pytest.mark.parametrize("variant", ["moving", "lognorm"])
def test_packed_config_variant_fields(variant):
    """The MovingThreshold flag, the window's node count, the per-mode
    threshold constants (the gamma percentile; the lognormal threshold) and
    the window's GL-16 nodes sit where csrc/coal_body.cuh reads them."""
    from cloudy_tpu_torch import harness

    _, data = harness.pod_data(variant)
    plan = fc.build_plan(data, ((50.0, 1.0 / 6.0),), NORMS, nz=32, dz=93.75, dt=1.0)
    buf = fc.pack_config(plan, torch.float64)
    ints = buf.view(np.int32)
    win = 16 if variant == "lognorm" else 0
    assert list(ints[8:10]) == [int(variant == "moving"), win]
    h, m = fc.HEADER_INTS, fc.MAX_MODES
    assert list(ints[h:h + m]) == [2 if variant == "lognorm" else 1, 1, 0]
    assert list(ints[h + 3 * m:h + 4 * m]) == [1, 0, 0]  # mode 0 thresholded
    reals = buf[int(ints[7]):].view(np.float64)
    assert reals[0] == (0.9 if variant == "moving" else 0.5)
    n_before = (m + 2 * fc.MAX_NTOT + len(plan.wb_nz) + len(plan.wf_nz)
                + 3 + 3 + 3 + 2 * 12)
    v, w = np.polynomial.legendre.leggauss(16)
    if win:
        np.testing.assert_array_equal(reals[n_before:n_before + 16], v)
        np.testing.assert_array_equal(reals[n_before + 16:n_before + 32], w)
    assert reals[n_before + 2 * win] == 1.0  # dt
    assert plan.arms == 1  # the kernels' instance with both arms


@pytest.mark.parametrize("fams,moving,arms", [
    ((Family.GAMMA, Family.GAMMA), False, 0),
    ((Family.EXPONENTIAL, Family.GAMMA), False, 0),
    ((Family.GAMMA, Family.GAMMA), True, 1),
    ((Family.LOGNORMAL, Family.GAMMA), False, 1),
], ids=["fixed_gamma", "fixed_exp_gamma", "moving_gamma", "fixed_lognormal"])
def test_plan_selects_kernel_instance(fams, moving, arms):
    """Only a MovingThreshold or lognormal configuration launches the
    kernels' instance compiled with those arms."""
    thresholds = (0.9, 1.0) if moving else (0.5, np.inf)
    plan = fc.build_plan(_data(fams, thresholds=thresholds, moving=moving,
                               lognorm_gl_nodes=16))
    assert plan.arms == arms


def test_moving_lognormal_percentile_constant():
    """Φ⁻¹(p) of a MovingThreshold lognormal mode is folded on the host in
    true f64 and rounded once (the reference builds it from a jnp.float64
    that truncates to f32 without x64)."""
    plan = fc.build_plan(_data((Family.LOGNORMAL, Family.GAMMA), thresholds=(0.9, 1.0),
                               moving=True, lognorm_gl_nodes=16))
    from cloudy_tpu_torch.ops import special

    want = float(special.ndtri(torch.tensor(0.9, dtype=torch.float64)))
    assert plan.thr_const[0] == want and abs(want - 1.2815515655446004) < 2e-9
    assert plan.thr_flag == (1, 0)
