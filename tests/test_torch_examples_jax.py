"""The port's deterministic example scripts against the JAX library, on the
CPU in FAST mode, f64.

Each script's ``main`` runs through `run_box_example`,
`run_condensation_example` or `run_rainshaft_example`; a spy on that call
records the configuration it was given (spectrum, moments, kernel tensor or
function, thresholds, times). The JAX package's script (examples/<name>.py)
runs with examples/common.py's run functions replaced by a recorder; the
two configurations must be equal (kernel tensors by their coefficients, bit
for bit; kernel functions by their fields), and the JAX package's own
pipeline runs JAX's in this process (examples/common.py's build →
integrate without its figures; under x64, as tests/conftest.py sets). A
box's JAX run takes JAX's RHS
jitted once and JAX's own step function in a Python loop (`_jax_run`), which
compiles in a third of `run_box`'s time. The final moments agree to rtol
1e-10, and so does the whole trajectory, element by element: the
analytical boxes of one to four modes (moving thresholds included), the
numerical-quadrature boxes (`n_particles`, `single_particle`), condensation
and the rainshafts. This file holds the boxes of one and two modes; the
others are in tests/test_torch_examples_jax_modes.py,
tests/test_torch_examples_jax_moving.py and
tests/test_torch_examples_jax_shaft.py (each file a worker's minute at most).

Two boxes carry a mode whose moments lie far below the round-off of the
large modes' rates (`COLUMN_SCALED`, `MODE_RTOL`; JAX's and the port's RHS
agree there to 1.4e-16 of the RHS's largest element, in f64):

- `box_gamma_mixture_3modes`: the third mode (1e-4 drops against 1e8)
  grows by seven orders in four steps; at the steps between, JAX's run
  moves by 5.7e-6 relative when its start moves by one ulp, and JAX's
  `run_box` and `_jax_run` differ by as much. Its final moments agree to
  1.4e-12, and its trajectory to 1.4e-12 of each moment's largest value
  (column-scaled).
- `box_gamma_mixture_4modes`: the third mode (1e-4 drops) barely moves;
  JAX's final moments there move by 7.8e-8 relative when its start moves
  by one ulp, and the port lies up to 5.8e-9 (final) and 1.2e-8 (column-
  scaled) from `_jax_run`, 8.4e-8 from `run_box`. That mode is held to
  rtol 1e-6, the other three to 1e-10.

Left out: `box_mono_gamma_mixture`, whose reference is ill-conditioned
(ROADMAP §C, "the monodisperse + gamma pulse"): JAX's own run moves by
7.4e-2 relative at its fourth step when its start moves by one ulp, and the
port's run lies 5.3e-2 from it there; the two agree to 4e-9 after one step.
"""

import importlib
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import stepper as jstepper
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.models import box as jbox, rainshaft as jrs

from cloudy_tpu_torch.examples import common

torch.set_num_threads(1)

JAX_EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
RUN_FUNCTIONS = ("run_box_example", "run_condensation_example", "run_rainshaft_example")
RTOL = 1e-10
CASES = ["box_single_gamma", "box_gamma_mixture", "box_single_lognorm", "box_lognorm_mixture",
         "box_gamma_mixture_long", "box_gamma_mixture_hydro", "box_single_gamma_hydro",
         "n_particles_exp", "n_particles_gamma", "n_particles_lognorm", "single_particle_exp",
         "single_particle_gamma"]
#: boxes whose trajectory is held to RTOL of each moment's largest value
#: along it (the module's docstring)
COLUMN_SCALED = {"box_gamma_mixture_3modes", "box_gamma_mixture_4modes"}
#: {mode: rtol} where a mode's moments lie below the round-off of the
#: others' rates (the module's docstring)
MODE_RTOL = {"box_gamma_mixture_4modes": {2: 1e-6}}


def _jax_script_call(name, monkeypatch):
    """(run function, args, kwargs) that the JAX package's
    examples/<name>.py passes to examples/common.py: the script runs with
    the run functions replaced by a recorder."""
    monkeypatch.syspath_prepend(str(JAX_EXAMPLES))
    jcommon = importlib.import_module("common")
    assert Path(jcommon.__file__).resolve() == JAX_EXAMPLES / "common.py"
    calls = []
    for fn in RUN_FUNCTIONS:
        if hasattr(jcommon, fn):
            monkeypatch.setattr(jcommon, fn,
                                lambda *a, _fn=fn, **kw: calls.append((_fn, a, kw)))
    runpy.run_path(str(JAX_EXAMPLES / f"{name}.py"))
    (call,) = calls
    return call


def _plain(v):
    """A configuration value of either package in comparable form."""
    if isinstance(v, (list, tuple)):
        return [_plain(u) for u in v]
    if hasattr(v, "families"):
        return ("spec", [int(f) for f in v.families])
    if type(v).__name__ == "CoalescenceTensor":
        return ("tensor", np.asarray(v.array, np.float64).tolist())
    if type(v).__name__.endswith("KernelFunction"):
        return (type(v).__name__, sorted((k, float(u)) for k, u in vars(v).items()))
    if isinstance(v, (np.ndarray, np.generic, int, float)):
        return np.asarray(v, np.float64).tolist()
    return v


def _jax_box(args, kw, condensation=False):
    spec, m0 = args[1], args[2]
    if condensation:
        defaults = dict(s=0.01, xi=1e-10, t_end=10.0, dt=0.25, norms=common.NORMS)
    else:
        defaults = dict(kernel=None, kernel_func=None, thresholds=None, moving=False,
                        t_end=120.0, dt=10.0, numerical=False, norms=common.NORMS)
    c = {**defaults, **kw}
    t_end, dt = common._fast_time(c["t_end"], c["dt"])
    config = jbox.BoxConfig(spec=spec, norms=c["norms"], t_end=t_end, dt=dt)
    if condensation:
        rhs = jbox.make_box_condensation_rhs(config, s=c["s"], xi=c["xi"])
    elif c["numerical"]:
        rhs = jbox.make_box_rhs(config, kernel_func=c["kernel_func"], numerical=True)
    else:
        thr = c["thresholds"] or (np.inf,) * spec.n_modes
        data = jbuild(spec, c["kernel"], thr, norms=c["norms"], moving=c["moving"])
        rhs = jbox.make_box_rhs(config, coal_data=data)
    return _jax_run(config, rhs, np.asarray(m0, np.float64))


def _jax_run(config, rhs, y0):
    """`jbox.run_box`'s trajectory (save_every 1) with the steps taken in
    Python: JAX's RHS jitted once, JAX's own step function between (the
    scan's body holds the RHS once per stage, and compiling it takes most of
    a case's time)."""
    assert config.save_every == 1
    f = jax.jit(rhs)
    step = jstepper.STEPPERS[config.method]
    y = jnp.asarray(y0)
    t, ys = jnp.asarray(0.0, y.dtype), [y]
    for _ in range(int(round(config.t_end / config.dt))):
        y, t = step(f, y, t, config.dt), t + config.dt
        ys.append(y)
    return np.asarray(jnp.stack(ys))


def _jax_rainshaft(args, kw):
    spec, amp = args[1], args[2]
    defaults = dict(kernel=None, thresholds=None, nz=60, zmax=3000.0, t_end=1000.0, dt=1.0,
                    norms=common.NORMS)
    c = {**defaults, **kw}
    t_end, dt = common._fast_time(c["t_end"], c["dt"])
    nz = min(c["nz"], 16)
    config = jrs.RainshaftConfig(spec=spec, nz=nz, zmax=c["zmax"], norms=c["norms"],
                                 t_end=t_end, dt=dt,
                                 save_every=max(1, int(t_end / dt) // 20))
    thr = c["thresholds"] or (np.inf,) * spec.n_modes
    data = jbuild(spec, c["kernel"], thr, norms=c["norms"])
    rhs = jrs.make_rainshaft_rhs(config, data)
    ic = jrs.initial_condition(config.z, amp[: spec.nprogmoms[0]])
    if spec.n_modes > 1:
        ic = np.concatenate([ic, np.zeros((nz, spec.n_tot - ic.shape[1]))], axis=-1)
    _, ys = jrs.run_rainshaft(config, rhs, jnp.asarray(ic))
    return np.asarray(ys)


def check_example_against_jax(name, tmp_path, monkeypatch):
    """Record the configuration the JAX package's script passes to its run
    function, run the port's script with a spy on its own, check that the
    two configurations are equal, then hold the port's trajectory against
    JAX's pipeline on JAX's configuration."""
    monkeypatch.setenv("CLOUDY_EXAMPLE_FAST", "1")
    fn_name, jargs, jkw = _jax_script_call(name, monkeypatch)
    mod = importlib.import_module(f"cloudy_tpu_torch.examples.{name}")
    calls = []
    real = getattr(mod, fn_name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(mod, fn_name, spy)
    got = mod.main(["--device", "cpu", "--outdir", str(tmp_path)])[-1].numpy()
    (args, kw), = calls
    kw = {k: v for k, v in kw.items() if k not in ("device", "outdir")}
    assert _plain(list(args)) == _plain(list(jargs))
    assert sorted(kw) == sorted(jkw)
    for k in kw:
        assert _plain(kw[k]) == _plain(jkw[k]), k
    if fn_name == "run_rainshaft_example":
        want = _jax_rainshaft(jargs, jkw)
    else:
        want = _jax_box(jargs, jkw, condensation=fn_name == "run_condensation_example")
    assert got.shape == want.shape and got.shape[0] == 5  # the start and four FAST steps
    rtol = np.full(got.shape[-1], RTOL)
    spec = args[1]
    for mode, r in MODE_RTOL.get(name, {}).items():
        rtol[spec.offsets[mode]:spec.offsets[mode] + spec.nprogmoms[mode]] = r
    np.testing.assert_array_less(np.abs(got[-1] - want[-1]), rtol * np.abs(want[-1]) + 1e-300)
    scale = np.abs(want).max(axis=0) if name in COLUMN_SCALED else np.abs(want)
    np.testing.assert_array_less(np.abs(got - want),
                                 np.broadcast_to(rtol * scale + 1e-300, got.shape))


@pytest.mark.parametrize("name", CASES)
def test_example_matches_jax(name, tmp_path, monkeypatch):
    check_example_against_jax(name, tmp_path, monkeypatch)
