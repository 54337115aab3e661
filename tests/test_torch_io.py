"""The port's output, checkpoint and metrics utilities against the JAX
package's.

- `partial_moment` and `get_standard_N_q` for all four families against
  JAX's in f64 (< 1e-12 relative), at thresholds 0, the rain cutoff, finite
  values and ∞;
- `box_output` and `rainshaft_output` against JAX's writers on the same
  trajectories: every variable to 1e-12, the same dimensions;
- the checkpoint contracts of tests/test_utils.py (round trip,
  `latest_step`, `run_segments` resumed 16 → 64), and the file format: a
  checkpoint written by either package loads in the other bit for bit;
- `StepTimer` and `JsonlLogger`.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from cloudy_tpu import distributions as jpd
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec
from cloudy_tpu.utils import checkpoint as jck
from cloudy_tpu.utils import io as jio

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.utils import checkpoint as ck
from cloudy_tpu_torch.utils import io, metrics

torch.set_num_threads(1)

FAMILIES = ("GAMMA", "EXPONENTIAL", "MONODISPERSE", "LOGNORMAL")


def _params(rng, n=64):
    """[n, 4, 3] f64 parameters of the four families in FAMILIES' order:
    gamma (n, θ, k), exponential and monodisperse (n, θ, 0), lognormal
    (n, μ, σ), with a few empty modes."""
    p = np.zeros((n, 4, 3))
    p[:, :, 0] = rng.uniform(1.0, 200.0, (n, 4))
    p[:, 0, 1:] = np.stack([rng.uniform(0.05, 5.0, n), rng.uniform(0.3, 8.0, n)], -1)
    p[:, 1, 1] = rng.uniform(0.02, 3.0, n)
    p[:, 2, 1] = rng.uniform(0.05, 3.0, n)
    p[:, 3, 1:] = np.stack([rng.uniform(-3.0, 1.0, n), rng.uniform(0.2, 1.5, n)], -1)
    p[:3, :, 0] = 0.0
    return p


@pytest.mark.parametrize("threshold", [0.0, io.RAIN_CUTOFF_KG / 1e-9, 1e-3, 0.25, 2.0, np.inf])
def test_partial_moment_and_partition_match_jax(threshold):
    spec = SpectrumSpec(tuple(Family[f] for f in FAMILIES))
    jspec = JSpec(tuple(JF[f] for f in FAMILIES))
    par = _params(np.random.default_rng(1))
    for q in (0.0, 1.0, 2.0, 0.5):
        got = pd.partial_moment(spec, torch.tensor(par), q, threshold).numpy()
        want = np.asarray(jpd.partial_moment(jspec, jnp.asarray(par), q, threshold))
        assert got.shape == want.shape == (par.shape[0], 4)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    got = pd.get_standard_N_q(spec, torch.tensor(par), threshold)
    want = jpd.get_standard_N_q(jspec, jnp.asarray(par), threshold)
    assert set(got) == set(want) == {"N_liq", "N_rai", "M_liq", "M_rai"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(want[k])).max())


def _box_traj(spec_names, n_t=4, seed=0):
    """(ts, ys [n_t, n_tot]) of tests/test_utils.py's kind: physical moments
    with 10 % noise on each."""
    rng = np.random.default_rng(seed)
    amps = {"GAMMA": [1e8, 1e-2, 2e-12], "EXPONENTIAL": [1.0, 1e-8],
            "LOGNORMAL": [1e7, 1e-3, 3e-13]}
    amp = np.concatenate([amps[f] for f in spec_names])
    ts = np.linspace(0, 30, n_t)
    return ts, np.abs(rng.normal(1, 0.1, (n_t, amp.size))) * amp


SPECS = [("GAMMA", "EXPONENTIAL"), ("LOGNORMAL", "GAMMA")]


def _assert_same_file(got_path, want_path, rtol=1e-12):
    with netcdf_file(got_path, "r", mmap=False) as g, netcdf_file(want_path, "r",
                                                                   mmap=False) as w:
        assert g.dimensions == w.dimensions
        assert set(g.variables) == set(w.variables)
        for name, wv in w.variables.items():
            gv = g.variables[name]
            assert gv.dimensions == wv.dimensions, name
            a, b = np.asarray(gv[:]), np.asarray(wv[:])
            assert a.shape == b.shape and a.dtype == b.dtype == np.dtype(">f8"), name
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("names", SPECS, ids=["gamma-exp", "lognormal-gamma"])
def test_box_output_matches_jax(names, tmp_path):
    spec = SpectrumSpec(tuple(Family[f] for f in names))
    jspec = JSpec(tuple(JF[f] for f in names))
    ts, ys = _box_traj(names)
    io.box_output(str(tmp_path / "port.nc"), spec, torch.tensor(ts), torch.tensor(ys))
    jio.box_output(str(tmp_path / "jax.nc"), jspec, ts, ys)
    _assert_same_file(tmp_path / "port.nc", tmp_path / "jax.nc")
    with netcdf_file(tmp_path / "port.nc", "r", mmap=False) as f:
        mom = np.asarray(f.variables["moments"][:])
        n0 = spec.nprogmoms[0]
        np.testing.assert_array_equal(mom[:, 0, :n0], ys[:, :n0])


@pytest.mark.parametrize("names", SPECS, ids=["gamma-exp", "lognormal-gamma"])
def test_rainshaft_output_matches_jax(names, tmp_path):
    """A [4, 5, n_tot] f32 trajectory on the port's side (a tensor, moved
    to the host and inverted in f64) and its f32 array on JAX's."""
    spec = SpectrumSpec(tuple(Family[f] for f in names))
    jspec = JSpec(tuple(JF[f] for f in names))
    ts, _ = _box_traj(names)
    nz = 5
    rng = np.random.default_rng(1)
    amp = _box_traj(names, n_t=1)[1][0]
    ys = (np.abs(rng.normal(1, 0.1, (4, nz, amp.size))) * amp).astype(np.float32)
    z = np.linspace(0, 3000, nz)
    io.rainshaft_output(str(tmp_path / "port.nc"), spec, ts, z, torch.tensor(ys))
    jio.rainshaft_output(str(tmp_path / "jax.nc"), jspec, ts, z, ys)
    _assert_same_file(tmp_path / "port.nc", tmp_path / "jax.nc")
    with netcdf_file(tmp_path / "port.nc", "r", mmap=False) as f:
        assert f.variables["moments"].shape == (4, nz, 2, 3)


def test_npz_roundtrip(tmp_path):
    ts, ys = _box_traj(("GAMMA", "EXPONENTIAL"))
    path = str(tmp_path / "traj.npz")
    io.save_npz(path, ts=torch.tensor(ts), ys=ys)
    data = io.load_npz(path)
    np.testing.assert_array_equal(data["ys"], ys)
    np.testing.assert_array_equal(data["ts"], ts)
    np.testing.assert_array_equal(jio.load_npz(path)["ys"], ys)


def test_checkpoint_roundtrip(tmp_path):
    state = {"mom": torch.ones((3, 4), dtype=torch.float32), "t": torch.tensor(1.5)}
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, state, step=7)
    got, step = ck.load_checkpoint(path, 7, like=state)
    assert step == 7 and set(got) == {"mom", "t"}
    assert got["mom"].dtype == torch.float32 and torch.equal(got["mom"], state["mom"])
    assert float(got["t"]) == 1.5
    assert ck.latest_step(path) == 7
    ck.save_checkpoint(path, state, step=12)
    assert ck.latest_step(path) == 12
    assert ck.latest_step(str(tmp_path / "other")) is None
    # like gives the dtype to restore to
    got64, _ = ck.load_checkpoint(path, 7, like={"mom": torch.zeros(3, 4, dtype=torch.float64),
                                                 "t": torch.tensor(0.0)})
    assert got64["mom"].dtype == torch.float64
    with pytest.raises(ValueError, match="more leaves"):
        ck.load_checkpoint(path, 7, like=state["mom"])


def test_checkpoint_of_another_shape_does_not_load(tmp_path):
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, {"mom": torch.ones(3, 4), "t": torch.tensor(1.5)}, step=7)
    with pytest.raises(ValueError, match=r"shape \(3, 4\) where `like` has \(3, 8\)"):
        ck.load_checkpoint(path, 7, like={"mom": torch.zeros(3, 8), "t": torch.tensor(0.0)})


def test_cut_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    """A save cut while it writes leaves only its temporary file, which
    `latest_step` passes over: the run resumes from the step before."""
    path = str(tmp_path / "seg")
    ck.run_segments(lambda y: y * 2.0, torch.tensor([1.0]), n_steps=4, segment=2,
                    ckpt_path=path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["seg_step2.npz", "seg_step4.npz"]

    def cut(f, **arrays):  # the process is cut after the zip's first bytes
        if isinstance(f, str):
            f = open(f, "wb")
        f.write(b"PK\x03\x04")
        f.flush()
        raise KeyboardInterrupt

    with monkeypatch.context() as m:
        m.setattr(np, "savez", cut)
        with pytest.raises(KeyboardInterrupt):
            ck.save_checkpoint(path, torch.tensor([32.0]), 6)
    # and one planted by hand: a step-8 file truncated mid-write
    whole = (tmp_path / "seg_step4.npz").read_bytes()
    (tmp_path / "seg_step8.npz.tmp").write_bytes(whole[: len(whole) // 2])
    assert ck.latest_step(path) == 4
    out, done = ck.run_segments(lambda y: y * 2.0, torch.tensor([1.0]), n_steps=6, segment=2,
                                ckpt_path=path)
    assert done == 6 and float(out[0]) == 64.0  # resumed from the step-4 state (16)
    assert ck.latest_step(path) == 6
    assert float(ck.load_checkpoint(path, 6, like=torch.zeros(1))[0][0]) == 64.0


def test_run_segments_resume(tmp_path):
    path = str(tmp_path / "seg")
    out, done = ck.run_segments(lambda y: y * 2.0, torch.tensor([1.0]), n_steps=4,
                                segment=2, ckpt_path=path)
    assert done == 4 and float(out[0]) == 16.0
    out2, done2 = ck.run_segments(lambda y: y * 2.0, torch.tensor([1.0]), n_steps=6,
                                  segment=2, ckpt_path=path)
    assert done2 == 6
    assert float(out2[0]) == 64.0  # resumed from the step-4 state (16) x 2 x 2
    out3, done3 = ck.run_segments(lambda y: y * 2.0, torch.tensor([1.0]), n_steps=6,
                                  segment=2, ckpt_path=path, resume=False)
    assert done3 == 6 and float(out3[0]) == 64.0


def _pod_state(n_cols=8, nz=32, seed=3):
    """A pod SoA state [6, n_cols·nz] f32 (the pod's profile, each column
    scaled)."""
    z = (np.arange(nz) + 0.5) * 3000.0 / nz
    ic1 = jrs.initial_condition(z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, 0.1 * ic1], axis=-1)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 1))
    return np.array(jrs.to_soa(jnp.asarray(np.tile(ic[None], (n_cols, 1, 1)) * amp,
                                             jnp.float32)))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX-written checkpoint of a pod SoA state, and of a dict, loads in
    the port bit for bit (the dict by JAX's sorted-key leaf order)."""
    soa = _pod_state()
    path = str(tmp_path / "pod")
    jck.save_checkpoint(path, jnp.asarray(soa), 40, use_orbax=False)
    like = torch.zeros(soa.shape, dtype=torch.float32)
    got, step = ck.load_checkpoint(path, ck.latest_step(path), like=like)
    assert step == 40 and got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(soa))
    tree = {"state": jnp.asarray(soa), "b": jnp.arange(3.0), "a": jnp.asarray(2.5)}
    jck.save_checkpoint(path + "_tree", tree, 5, use_orbax=False)
    like = {"state": like, "b": torch.zeros(3, dtype=torch.float64),
            "a": torch.tensor(0.0, dtype=torch.float64)}
    got, _ = ck.load_checkpoint(path + "_tree", 5, like=like)
    assert torch.equal(got["state"], torch.from_numpy(soa))
    assert got["b"].tolist() == [0.0, 1.0, 2.0] and float(got["a"]) == 2.5


def test_port_checkpoint_resumes_in_jax(tmp_path):
    soa = _pod_state(seed=4)
    path = str(tmp_path / "pod")
    ck.save_checkpoint(path, rs.to_soa(rs.from_soa(torch.from_numpy(soa), 32)), 80)
    assert jck.latest_step(path) == 80
    got, step = jck.load_checkpoint(path, 80, like=jnp.zeros(soa.shape, jnp.float32))
    assert step == 80 and np.asarray(got).dtype == np.float32
    np.testing.assert_array_equal(np.asarray(got), soa)
    tree = {"z": torch.arange(4.0), "mom": torch.from_numpy(soa)}
    ck.save_checkpoint(path + "_tree", tree, 3)
    got, _ = jck.load_checkpoint(path + "_tree", 3,
                                 like={"z": jnp.zeros(4), "mom": jnp.zeros(soa.shape)})
    np.testing.assert_array_equal(np.asarray(got["mom"]), soa)
    np.testing.assert_array_equal(np.asarray(got["z"]), np.arange(4.0))


def test_step_timer_and_jsonl_logger(tmp_path):
    t = metrics.StepTimer()
    for _ in range(3):
        out = t.timed_call(lambda x: x * 2, torch.ones(8))
    assert torch.equal(out, torch.full((8,), 2.0))
    with t.time_step():
        torch.ones(4).sum()
    s = t.summary()
    assert set(s) == {"n", "mean_s", "p50_s", "p95_s", "min_s"}
    assert s["n"] == 4 and s["mean_s"] > 0 and s["min_s"] <= s["p50_s"] <= s["p95_s"]
    one = metrics.StepTimer([0.5])
    assert one.summary()["mean_s"] == 0.5  # one call: nothing to drop
    assert metrics.StepTimer([9.0, 1.0, 3.0]).summary()["mean_s"] == 2.0  # first dropped
    path = tmp_path / "log.jsonl"
    log = metrics.JsonlLogger(str(path))
    log.log({"a": 1})
    log.log({"b": None})
    assert [json.loads(ln) for ln in path.read_text().splitlines()] == [{"a": 1}, {"b": None}]
