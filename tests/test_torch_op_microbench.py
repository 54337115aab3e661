"""The chain benchmark (B6) of the port against the JAX tool
(tools/op_microbench.py): the chain table, the twin against the JAX link
functions and against the Pallas kernel body in interpret mode, the
least-squares fit against the JAX tool's `--refit`, and the per-class
operation counts the class model reads.

Tolerances: the twin against the JAX links at each chain's K1 (bundles 4,
gammaincinv_gl12 2), relative per element, f32 1e-5 (torch's and XLA's f32
exp/log differ by an ulp, which the bundles' cancellations amplify) and f64
1e-12; the fit against JAX's 1e-9 relative (the same NNLS on the same
system: what is left is summation order).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from cloudy_tpu_torch.ops import op_chains as oc
from cloudy_tpu_torch.tools import op_microbench as om
from cloudy_tpu_torch.tools import opcount

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "op_microbench.py")
TOL = {"f32": 1e-5, "f64": 1e-12}


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_op_microbench", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JOM = _jax_tool()


def _blocks(dt, seed=11):
    """ILP 2 blocks [8, 128] from a numpy seed, U(0.3, 0.9) as the tools draw."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.3, 0.9, (2, 8, 128)).astype(np.float32 if dt == "f32" else np.float64)


def test_chain_table_matches_jax():
    assert list(oc.CHAINS) == list(JOM.CHAINS)
    assert oc.CLASSES == JOM.CLASSES
    for name in JOM.CHAINS:
        assert oc.CHAINS[name][0] == JOM.CHAINS[name][0], name
    assert set(oc.BUNDLES) == set(JOM.BUNDLES)
    assert (oc.K1, oc.K1_BUNDLE) == (JOM.K1, JOM.K1_BUNDLE)
    assert oc.NAMES == tuple(JOM.CHAINS)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", list(oc.CHAINS))
def test_chain_plain_matches_jax_links(name, dt):
    x = _blocks(dt)
    k = oc.k1_of(name)
    link = JOM.CHAINS[name][1]
    want = []
    for block in x:
        y = jnp.asarray(block)
        for _ in range(k):
            y = link(jnp, y)
        assert y.dtype == block.dtype
        want.append(np.asarray(y, np.float64))
    got = oc.chain_plain(name, torch.as_tensor(x), k)
    assert got.dtype == torch.as_tensor(x).dtype
    rel = np.abs(got.double().numpy() / np.stack(want) - 1.0).max()
    assert rel <= TOL[dt], (name, dt, rel)


@pytest.mark.parametrize("name", ["exp", "expdiv", "gammaincinv_gl12"])
def test_pallas_body_matches_twin(name):
    """JAX's own kernel body `_kernel(name, 4, 2)` through `pallas_call` in
    interpret mode, f32, against the twin at 4 links."""
    x = _blocks("f32", seed=3)
    call = pl.pallas_call(
        JOM._kernel(name, 4, 2),
        out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32)] * 2,
        interpret=True,
    )
    want = np.stack([np.asarray(o, np.float64) for o in call(*[jnp.asarray(b) for b in x])])
    got = oc.chain_plain(name, torch.as_tensor(x), 4).double().numpy()
    assert np.abs(got / want - 1.0).max() <= TOL["f32"]


def _system():
    return np.array(
        [[oc.CHAINS[n][0].get(c, 0) for c in oc.CLASSES] + [1.0] for n in oc.CHAINS], float)


def _costs(seed=5):
    """Class costs and a memory column of the size the card gives (s per
    element-op)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(3e-14, 3e-13, len(oc.CLASSES) + 1)
    t[7:13] *= 30.0  # the bundles cost tens of primitive operations
    return t


def test_fit_matches_jax_refit(tmp_path):
    """One links file, refit by the JAX tool in a subprocess (which writes
    only that file) and by the port: every class cost, the memory column and
    the residuals agree to 1e-9 relative."""
    rng = np.random.default_rng(9)
    b = _system() @ _costs() * rng.uniform(0.8, 1.25, len(oc.CHAINS))
    links = dict(zip(oc.CHAINS, b.tolist()))
    path = tmp_path / "links.json"
    path.write_text(json.dumps({"op_costs": {"chain_sec_per_elem_link": links}}))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, JAX_TOOL, "--refit", "--out", str(path)],
                         capture_output=True, text=True, env=env, cwd=str(tmp_path),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(os.listdir(tmp_path)) == ["links.json"]
    want = json.loads(path.read_text())["op_costs"]
    got = om.fit(links)
    for c in oc.CLASSES:
        np.testing.assert_allclose(got["classes"][c]["sec_per_elem_op"],
                                   want["classes"][c]["sec_per_elem_op"], rtol=1e-9, atol=0.0)
        np.testing.assert_allclose(got["classes"][c]["slots_vs_mul"],
                                   want["classes"][c]["slots_vs_mul"], rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(got["mem_sec_per_elem_link"], want["mem_sec_per_elem_link"],
                               rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(got["ls_residual_rel_max"], want["ls_residual_rel_max"],
                               rtol=1e-9, atol=0.0)
    # the bundle rows fit exactly: their residuals are rounding (~1e-16),
    # compared against the largest residual's scale
    scale = want["ls_residual_rel_max"]
    for n in oc.CHAINS:
        np.testing.assert_allclose(got["ls_residual_rel"][n], want["ls_residual_rel"][n],
                                   rtol=1e-9, atol=1e-9 * scale)


def test_fit_recovers_known_costs():
    """Links generated from chosen class costs give those costs back."""
    t = _costs(seed=6)
    links = dict(zip(oc.CHAINS, (_system() @ t).tolist()))
    f = om.fit(links)
    got = [f["classes"][c]["sec_per_elem_op"] for c in oc.CLASSES]
    np.testing.assert_allclose(got, t[:-1], rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(f["mem_sec_per_elem_link"], t[-1], rtol=1e-9, atol=0.0)
    assert f["ls_residual_rel_max"] < 1e-12
    assert f["classes"]["mul"]["slots_vs_mul"] == 1.0


def test_count_ops_by_class_counts_each_class():
    x = torch.linspace(0.1, 1.0, 40, dtype=torch.float64)

    def fn(v):  # adds: + 1.0, + 2.0, the subtraction and the clamp
        y = torch.where(v > 0.5, torch.exp(v) * 2.0 + 1.0, v / 3.0)
        return torch.sqrt(torch.log(y + 2.0) - torch.clamp(y, max=0.7)).abs()

    c = opcount.count_ops_by_class(fn, x)
    assert {k: c[k] for k in oc.PRIMITIVE_CLASSES} == {
        "mul": 40, "add": 160, "div": 40, "exp": 40, "log": 40, "sqrt": 40, "sel": 40}
    assert c["other"] == {"abs": 40}
    assert c["predicate"] == {"gt": 40}
    assert sum(c[k] for k in oc.PRIMITIVE_CLASSES) + 40 == opcount.count_ops(fn, x)


def test_count_ops_data_only():
    """`data_only` leaves out the operations on constants alone, also once
    broadcast to the data's shape, and the classes still add up."""
    x = torch.linspace(0.1, 1.0, 40)

    def fn(v):  # per element: the mul and the add; the exp and sqrt are a's
        a = torch.tensor(2.5)
        return v * torch.sqrt(a).expand_as(v) + torch.exp(a.expand(v.shape))

    assert opcount.count_ops(fn, x) == 40 * 3 + 1
    assert opcount.count_ops(fn, x, data_only=True) == 40 * 2
    for name in oc.CHAINS:
        def link(v):
            return oc.chain_plain(name, v, 1)

        full = opcount.count_ops(link, x)
        data = opcount.count_ops(link, x, data_only=True)
        c = opcount.count_ops_by_class(link, x, data_only=True)
        assert sum(c[k] for k in oc.PRIMITIVE_CLASSES) + sum(c["other"].values()) == data
        assert om.link_ops(name)["mul"] * 8 == opcount.count_ops_by_class(
            link, om.inputs(1, 8, torch.float32, "cpu"), data_only=True)["mul"]
        if name == "gammaincinv_gl12":  # a = 2.5's start, lgamma(a + 1), gln4, a + j
            assert data < full - 90 * 40
        elif name == "gammainc_gl12":  # a = 4.5 stays 0-d: a - 1, sqa and its multiples
            assert data == full - 9
        else:
            assert data == full, name


def test_count_ops_by_class_b1_step():
    """One twin step of B1 `fixed2gamma` on 64 lanes: the floating-point
    classes and `other` add up to `count_ops`, `other` is reported, and the
    class model prices the step."""
    from cloudy_tpu_torch import harness

    sc = harness.SCENARIOS["pod_ensemble"](n_columns=2, device="cpu", dtype=torch.float32)
    x = sc["state0"]
    assert x.shape[1] == 64
    c = opcount.count_ops_by_class(sc["step"].plain, x)
    total = opcount.count_ops(sc["step"].plain, x)
    assert sum(c[k] for k in oc.PRIMITIVE_CLASSES) + sum(c["other"].values()) == total
    assert c["other"] and all(n > 0 for n in c["other"].values())
    assert c["predicate"] and c["exp"] > 0 and c["div"] > 0
    links = dict(zip(oc.CHAINS, (_system() @ _costs()).tolist()))
    classes = om.fit(links)["classes"]
    per_lane = {k: (v / 64 if not isinstance(v, dict) else {o: n / 64 for o, n in v.items()})
                for k, v in c.items()}
    ms = om.predict_ms(per_lane, 1 << 25, classes)
    want = (1 << 25) * 1e3 * (
        sum(per_lane[k] * classes[k]["sec_per_elem_op"] for k in oc.PRIMITIVE_CLASSES)
        + sum(per_lane["predicate"].values()) * classes["add"]["sec_per_elem_op"])
    assert ms == pytest.approx(want, rel=1e-12)


def test_chain_wrapper_runs_twin_on_cpu_and_checks():
    fn = oc.chain_kernel("expdiv", torch.float64)
    assert oc.chain_kernel("expdiv", torch.float64) is fn
    x = om.inputs(oc.ILP, 128, torch.float64, "cpu", seed=11)
    before = fn.launches
    np.testing.assert_array_equal(fn(x, 3).numpy(), oc.chain_plain("expdiv", x, 3).numpy())
    assert fn.launches == before  # the twin counts no launch
    with pytest.raises(ValueError, match="float32"):
        fn(x.float(), 3)
    with pytest.raises(ValueError, match="ilp"):
        fn(torch.ones(3, 8, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.ones(16, 8, dtype=torch.float64).T, 3)
    with pytest.raises(ValueError, match="unknown chain"):
        oc.ChainFn("pow", torch.float32)


def test_tool_on_the_host_and_refit(tmp_path, capsys):
    """`--device cpu` runs the protocol through the twin (host times, no
    launch), writes only DIR/op_microbench.json, and `--refit` reproduces
    its fit."""
    om.main(["--device", "cpu", "--dtype", "f32", "--reps", "1", "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == ["op_microbench.json"]
    doc = json.loads((tmp_path / "op_microbench.json").read_text())
    assert doc["card"].startswith("cpu")
    assert [r["chain"] for r in doc["records"]] == list(oc.CHAINS)
    for r in doc["records"]:
        assert r["dtype"] == "f32" and r["ilp"] == 8 and r["E"] == 8 * r["columns"]
        assert r["k2"] > r["k1"] == oc.k1_of(r["chain"])
        assert r["launches"] == 0 and r["max_rel_err"] == 0.0 and r["sec_per_elem_link"] > 0
        x = om.inputs(1, 8, torch.float32, "cpu")
        assert r["ops_per_elem_link"] * 8 == opcount.count_ops(
            lambda v, name=r["chain"]: oc.chain_plain(name, v, 1), x, data_only=True)
        if r["chain"] in om.CANCELLING:  # on the host the kernel is the f32 twin
            assert r["vs"] == "f64 twin" and r["tol"] == om.TOL_CANCELLING
            assert r["f64_rel_err"] == r["twin_f64_rel_err"] <= om.TOL_CANCELLING
        else:
            assert r["vs"] == "twin" and r["tol"] == om.TOL[torch.float32]
    capsys.readouterr()
    om.main(["--refit", str(tmp_path / "op_microbench.json")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == doc["fits"]
