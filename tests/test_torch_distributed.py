"""Multi-process bring-up of the port over `torch.distributed` on the CPU:
two gloo processes on a free local port run the column-sharded ensemble
step, and the harness's sharded pod route, against one process and the JAX
package; the failure policy of `initialize_distributed` (the torch form of
tests/test_distributed.py:104-184)."""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cloudy_tpu import kernels as JK
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.parallel.ensemble import ensemble_rainshaft_step as jensemble_step
from cloudy_tpu.parallel.mesh import make_mesh as jmake_mesh
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec

from cloudy_tpu_torch import harness
from cloudy_tpu_torch.parallel import mesh as pmesh
from cloudy_tpu_torch.utils import checkpoint as ck

import _torch_dist_worker as worker

torch.set_num_threads(1)


def test_two_process_cluster_column_sharded_step(tmp_path):
    """Two gloo ranks, 4 of 8 columns x 8 levels each, one SSPRK33 step with
    the all-mode mass diagnostic: each rank's shard equals its unsharded
    step (rtol 1e-12, atol 0, tests/test_distributed.py:91); the
    all-reduced mass is the same on both ranks and is Σ_i M1^i over every
    rank's columns; the union of the shards and the mass against JAX's
    `ensemble_rainshaft_step` on its 8-device mesh (1e-12)."""
    worker.launch("column", tmp_path)
    ranks = [np.load(tmp_path / f"column_rank{r}.npz") for r in range(2)]
    for z in ranks:
        np.testing.assert_allclose(z["y1"], z["local_step"], rtol=1e-12, atol=0.0)
    assert float(ranks[0]["total"]) == float(ranks[1]["total"])
    y1 = np.concatenate([z["y1"] for z in ranks])
    spec = JSpec((JFamily.GAMMA, JFamily.GAMMA))
    want_mass = sum(y1[..., spec.dist_moment_ind(i, 1)].sum() for i in range(2))
    np.testing.assert_allclose(float(ranks[0]["total"]), want_mass, rtol=1e-12)
    assert abs(y1[..., 1].sum() - want_mass) / want_mass > 1e-3  # mode 2 holds mass

    ker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    data = jbuild(spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9))
    config = jrs.RainshaftConfig(spec=spec, nz=8, zmax=3000.0, norms=(1e6, 1e-9), dt=1.0)
    mesh = jmake_mesh(("columns",))
    step = jensemble_step(jrs.make_rainshaft_rhs(config, data), 1.0, mesh,
                          with_diagnostics=True, spec=spec)
    state = worker.global_state(config, 8)
    state[..., 3:6] = 0.3 * state[..., 0:3]
    jy, jmass = jax.jit(step)(jax.device_put(jnp.asarray(state),
                                             NamedSharding(mesh, P("columns"))))
    np.testing.assert_allclose(y1, np.asarray(jy), rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(float(ranks[0]["total"]), float(jmass), rtol=1e-12)


def test_harness_two_ranks_match_one(tmp_path):
    """The pod scenario at 8 columns through the harness's sharded route on
    two gloo ranks (4 columns each) against one process: the union of the
    final shards is the one-process state bit for bit; the report counts
    the global columns, totals all-reduced; a checkpointed run cut after 40
    steps and resumed is the plain run bit for bit, its newest checkpoint
    is one file with the global state, and rank 0 wrote the mean profile;
    a resume at another width is refused on every rank."""
    worker.launch("harness", tmp_path)
    ranks = [np.load(tmp_path / f"harness_rank{r}.npz") for r in range(2)]
    with open(tmp_path / "harness_rank0.npz.json") as f:
        reps = json.load(f)
    one, rep1 = harness.run_scenario("pod_ensemble", device="cpu", n_columns=8)
    union = np.concatenate([z["state"] for z in ranks])
    np.testing.assert_array_equal(union, one.numpy())
    np.testing.assert_array_equal(np.concatenate([z["resumed"] for z in ranks]), union)
    plain, res = reps["plain"], reps["resumed"]
    assert (plain["n_columns"], plain["world_size"], plain["n_local_columns"]) == (8, 2, 4)
    assert rep1["world_size"] == 1 and rep1["n_local_columns"] == 8
    assert plain["column_updates_per_s"] == 8 * 120 / plain["seconds"]
    assert plain["launches"] == 0 and plain["finite"]  # the twin on the CPU: no launch
    for key in ("total_number", "total_mass"):
        assert plain[key] == pytest.approx(rep1[key], rel=1e-6)
    assert plain["negative_fraction"] == rep1["negative_fraction"] == 0.0
    assert res["resumed_from_step"] == 40 and res["n_steps_run"] == 80
    assert reps["refused"]  # a checkpoint of 8 columns does not resume 16
    saved, step = ck.load_checkpoint(str(tmp_path / "ckpt" / "pod_ensemble"), 120)
    assert step == 120 and saved[0].shape == (6, 8 * 32)
    np.testing.assert_array_equal(saved[0], harness.rs.to_soa(one).numpy())
    assert sorted(os.listdir(tmp_path / "out")) == ["pod_ensemble_mean_profile.nc",
                                                    "runs.jsonl"]
    from scipy.io import netcdf_file

    with netcdf_file(str(tmp_path / "out" / "pod_ensemble_mean_profile.nc"), "r",
                     mmap=False) as f:
        mom = f.variables["moments"][:].astype(np.float64)
    last = np.concatenate([mom[-1, :, i, :] for i in range(2)], axis=-1)
    np.testing.assert_allclose(last, one.double().mean(dim=0).numpy(), rtol=1e-6)


@pytest.fixture
def no_cluster_env(monkeypatch):
    for v in pmesh._CLUSTER_ENV_VARS + ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)


def test_initialize_raises_when_cluster_env_present(monkeypatch, no_cluster_env):
    """A detected cluster launch whose initialisation fails raises, never
    degrading into single-process runs: SLURM's signal with no rendezvous
    address, and torchrun's with a failing init."""
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "2")
    assert pmesh.cluster_env_detected()
    with pytest.raises(RuntimeError, match="refusing to continue"):
        pmesh.initialize_distributed(device="cpu")  # env:// without MASTER_ADDR

    def boom(*args, **kwargs):
        raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.delenv("SLURM_JOB_NUM_NODES")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert pmesh.cluster_env_detected()
    with pytest.raises(RuntimeError, match="refusing to continue"):
        pmesh.initialize_distributed(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not pmesh.cluster_env_detected()
    with pytest.raises(RuntimeError, match="refusing to continue"):  # explicit arguments
        pmesh.initialize_distributed("tcp://localhost:1", 2, 0, device="cpu")


def test_initialize_noop_without_cluster(monkeypatch, no_cluster_env):
    """No cluster signal at all: False, and no process group is made."""
    def boom(*args, **kwargs):
        raise AssertionError("init_process_group called without a cluster signal")

    monkeypatch.setattr(dist, "init_process_group", boom)
    assert not pmesh.cluster_env_detected()
    assert pmesh.initialize_distributed() is False
    assert pmesh.world() == (1, 0)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh()


def test_initialize_already_initialized(monkeypatch):
    """With a process group up, the call reports it (True for more than one
    rank) instead of raising; the backend follows the device."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    assert pmesh.initialize_distributed() is False
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    assert pmesh.initialize_distributed() is True
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pmesh.rank_device("cuda") == torch.device("cuda", 3)
    assert pmesh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert pmesh.rank_device("cpu") == torch.device("cpu")
