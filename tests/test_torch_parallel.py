"""The port's `parallel` package (`cloudy_tpu_torch.parallel`) on the CPU:
the flat SoA column routes, the z-split halo step and its overlap order,
the mesh and the scaling sweep over two gloo processes (the torch form of
tests/test_parallel.py:46-135), and each function's single-process path
(no process group: no collective)."""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import cloudy_tpu.parallel as jparallel
from cloudy_tpu import kernels as JK
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.parallel.halo import make_z_sharded_rainshaft_rhs as jz_rhs, z_sharded_step
from cloudy_tpu.parallel.mesh import make_mesh as jmake_mesh
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec

import cloudy_tpu_torch.parallel as parallel
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.parallel import ensemble, halo, scaling

import _torch_dist_worker as worker

torch.set_num_threads(1)


def test_exports_match_jax():
    assert parallel.__all__ == jparallel.__all__


def test_column_sharded_soa_matches_unsharded(tmp_path):
    """Two gloo ranks, 8 of 16 columns x 16 levels each, f64: the whole-step
    wrapper through `ensemble_whole_step` and the fused-RHS route through
    `ensemble_rainshaft_step_soa` equal their unsharded calls on the global
    state bit for bit (columns are independent; the stencil stays inside a
    column); a shard of partial columns raises in both (checked by the
    ranks)."""
    worker.launch("soa", tmp_path)
    ranks = [np.load(tmp_path / f"soa_rank{r}.npz") for r in range(2)]
    spec, data, config = worker.flagship(16)
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data

    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    fdata = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=worker.NORMS,
                                   fast_tier=True)
    soa = rs.to_soa(torch.from_numpy(worker.global_state(config, 16)))
    whole = fc.make_rainshaft_step_fn(fdata, config.vel, config.norms, nz=16, dz=config.dz,
                                      dt=1.0, device="cpu", dtype=torch.float64)
    fused = fc.make_rainshaft_rhs_fn(fdata, config.vel, config.norms, device="cpu",
                                     dtype=torch.float64)
    want_whole = whole(soa).numpy()
    want_fused = worker.unsharded_step(rs.make_rainshaft_rhs_fused(config, fused), soa).numpy()
    for key, want in (("whole", want_whole), ("fused", want_fused)):
        got = np.concatenate([z[key] for z in ranks], axis=1)
        np.testing.assert_array_equal(got, want)


def test_z_sharded_halo_matches_unsharded(tmp_path):
    """z split over two gloo ranks (8 columns x 16 levels, 8 levels each,
    f64): the step equals the port's unsharded AoS step
    (`make_rainshaft_rhs` + `ssprk33_step`) bit for bit, and JAX's
    z-sharded step on its (4, 2) mesh (rtol 1e-12, atol 1e-20,
    tests/test_parallel.py:97-119)."""
    worker.launch("zhalo", tmp_path)
    ranks = [np.load(tmp_path / f"zhalo_rank{r}.npz") for r in range(2)]
    got = np.concatenate([z["y1"] for z in ranks], axis=1)
    spec, data, config = worker.flagship(16)
    state = torch.from_numpy(worker.global_state(config, 8))
    want = worker.unsharded_step(rs.make_rainshaft_rhs(config, data), state).numpy()
    np.testing.assert_array_equal(got, want)

    jspec = JSpec((JFamily.GAMMA, JFamily.GAMMA))
    ker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    jdata = jbuild(jspec, ker, (5e-10, np.inf), norms=(1e6, 1e-9))
    jcfg = jrs.RainshaftConfig(spec=jspec, nz=16, zmax=3000.0, norms=(1e6, 1e-9), dt=1.0)
    mesh = jmake_mesh(("columns", "z"), (4, 2))
    step = jax.jit(z_sharded_step(jz_rhs(jspec, jdata, jcfg.dz, jcfg.vel, (1e6, 1e-9)), 1.0,
                                  mesh))
    jy = step(jax.device_put(jnp.asarray(state.numpy()), NamedSharding(mesh, P("columns", "z"))))
    np.testing.assert_allclose(got, np.asarray(jy), rtol=1e-12, atol=1e-20)


def test_halo_receive_posted_before_coalescence(tmp_path):
    """The overlap order of halo.py:71-90 in torch: on the lower block, the
    receive of the upper block's cell is posted before the coalescence runs
    (`get_coal_ints` and `torch.distributed.irecv` patched to log their
    calls); the upper block posts none. `halo_from_above` gives the lower
    block the upper block's bottom cell and the top block `fill`."""
    worker.launch("zhalo", tmp_path)
    lo, hi = (np.load(tmp_path / f"zhalo_rank{r}.npz") for r in range(2))
    assert list(lo["events"]) == ["irecv", "coal"]
    assert list(hi["events"]) == ["coal", "coal"]
    spec, data, config = worker.flagship(16)
    state = worker.global_state(config, 8)
    np.testing.assert_array_equal(lo["halo"], state[:, 8:9, :])
    np.testing.assert_array_equal(hi["halo"], np.full_like(state[:, :1, :], -1.0))


def test_mesh_over_two_ranks(tmp_path):
    """`make_mesh` names its axes and sizes over the group; sizes whose
    product is not the world size raise `ValueError`; a second
    `initialize_distributed` reports the group (True)."""
    worker.launch("mesh", tmp_path)
    for r in range(2):
        with open(tmp_path / f"mesh_rank{r}.json") as f:
            got = json.load(f)
        assert got["sizes"] == [2, 1] and got["local_rank"] == r
        assert got["again"] is True and got["world"] == [2, r]
        assert "!= 2 ranks" in got["bad_sizes"]


def test_scaling_sweep_two_ranks(tmp_path):
    """The weak-scaling sweep over 1 and 2 gloo ranks: one record per
    point, the same on both ranks, efficiency 1.0 at one rank."""
    worker.launch("sweep", tmp_path)
    recs = []
    for r in range(2):
        with open(tmp_path / f"sweep_rank{r}.json") as f:
            recs.append(json.load(f))
    assert recs[0] == recs[1]
    assert [x["devices"] for x in recs[0]] == [1, 2]
    assert recs[0][0]["efficiency"] == 1.0
    assert all(x["columns_per_s"] > 0 and x["efficiency"] > 0 for x in recs[0])


def test_scaling_sweep_one_rank():
    """Without a process group the sweep is one point: its record's fields
    and efficiency 1.0 at one device (the rate is the host's: a CPU
    number, not a device metric)."""
    spec, data, config = worker.flagship(8)
    rhs = rs.make_rainshaft_rhs(config, data)
    recs = scaling.scaling_sweep(rhs, 1.0, 8, 6, columns_per_device=8, device="cpu", n_steps=2)
    assert len(recs) == 1 and set(recs[0]) == {"devices", "columns_per_s", "efficiency"}
    assert recs[0]["devices"] == 1 and recs[0]["efficiency"] == 1.0
    assert recs[0]["columns_per_s"] > 0
    with pytest.raises(ValueError, match="ranks asked"):
        scaling.scaling_sweep(rhs, 1.0, 8, 6, columns_per_device=8, device_counts=[2],
                              device="cpu")


def test_single_process_paths():
    """Without a process group (``mesh=None``) the wrappers run their step
    as it is and reduce nothing: the all-mode mass is the local Σ_i M1^i
    (not mode 1's M1 alone), a missing `spec` raises, partial columns
    raise, the z-split RHS is `make_rainshaft_rhs` bit for bit (the top
    block's influx is `fill`)."""
    spec, data, config = worker.flagship(8)
    rhs = rs.make_rainshaft_rhs(config, data)
    state = worker.global_state(config, 4)
    state[..., 3:6] = 0.3 * state[..., 0:3]
    y = torch.from_numpy(state)
    y1, mass = ensemble.ensemble_rainshaft_step(rhs, 1.0, None, with_diagnostics=True,
                                                spec=spec)(y)
    want = worker.unsharded_step(rhs, y)
    assert torch.equal(y1, want)
    assert float(mass) == pytest.approx(float(want[..., 1].sum() + want[..., 4].sum()),
                                        rel=1e-14)
    assert abs(float(mass) - float(want[..., 1].sum())) / float(mass) > 1e-3
    with pytest.raises(ValueError, match="SpectrumSpec"):
        ensemble.ensemble_rainshaft_step(rhs, 1.0, None, with_diagnostics=True)
    assert torch.equal(ensemble.shard_columns(lambda v: v * 2, None)(y), y * 2)

    zrhs = halo.make_z_sharded_rainshaft_rhs(spec, data, config.dz, config.vel, config.norms)
    assert torch.equal(zrhs(y, 0.0), rhs(y, 0.0))
    assert torch.equal(halo.z_sharded_step(zrhs, 1.0)(y), want)
    assert torch.equal(halo.halo_from_above(y, None, fill=2.0), torch.full_like(y[:, :1], 2.0))

    step = fc.make_rainshaft_step_fn(data, config.vel, config.norms, nz=8, dz=config.dz,
                                     dt=1.0, device="cpu", dtype=torch.float64)
    soa = rs.to_soa(y)
    assert torch.equal(ensemble.ensemble_whole_step(step, None)(soa), step(soa))
    with pytest.raises(ValueError, match="whole number"):
        ensemble.ensemble_whole_step(step, None)(soa[:, :12].contiguous())
    with pytest.raises(ValueError, match="whole number"):
        ensemble.ensemble_rainshaft_step_soa(rhs, 1.0, None, nz=8)(soa[:, :12].contiguous())
    assert ensemble.gather_columns(soa, None) is soa


def test_scaling_measure_tool_cpu(capsys):
    """`tools.scaling_measure` at 64 columns on the CPU through both routes:
    one JSON record each with the rate's fields (host clock, the twin: no
    launch); one step of the fused route's state and of the AoS route's
    agree (f32, the same fast-tier data, 1e-4 of each moment's scale)."""
    from cloudy_tpu_torch.tools import scaling_measure as sm

    sm.main(["--device", "cpu", "--columns", "64", "--steps", "2", "--reps", "1"])
    sm.main(["--device", "cpu", "--columns", "64", "--steps", "2", "--reps", "1", "--aos"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["route"] for r in recs] == ["fused_rhs", "aos_torch_ops"]
    for r in recs:
        assert (r["n_columns"], r["world_size"], r["nz"], r["clock"]) == (64, 1, 32, "host")
        assert r["column_updates_per_s"] == pytest.approx(64 * 2 / (r["ms_per_step"] * 2e-3))
        assert r["level_updates_per_s"] == r["column_updates_per_s"] * 32
    assert recs[0]["launches"] == 0 and recs[1]["launches"] is None
    _, config, fused_step, _ = sm.build_step(True, device="cpu")
    _, _, aos_step, _ = sm.build_step(False, device="cpu")
    y_f = rs.from_soa(fused_step(sm.make_state(config, 4, True, "cpu", torch.float32)), 32)
    y_a = aos_step(sm.make_state(config, 4, False, "cpu", torch.float32))
    scale = y_a.abs().amax(dim=(0, 1))
    assert float(((y_f - y_a).abs() / scale).max()) < 1e-4
