"""One rank of a multi-process `torch.distributed` run of the port on the
CPU (gloo), for tests/test_torch_parallel.py and
tests/test_torch_distributed.py:

    python tests/_torch_dist_worker.py CASE PORT RANK WORLD OUTDIR

Each case brings up the process group through
`cloudy_tpu_torch.parallel.mesh.initialize_distributed`, runs its sharded
path, checks what one rank can check, and writes what the test compares
to OUTDIR/CASE_rank{RANK}.npz (or .json). It imports torch and the port
only: the test computes the JAX side.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cloudy_tpu_torch import kernels as K  # noqa: E402
from cloudy_tpu_torch import stepper  # noqa: E402
from cloudy_tpu_torch.coalescence import build_coalescence_data  # noqa: E402
from cloudy_tpu_torch.models import rainshaft as rs  # noqa: E402
from cloudy_tpu_torch.parallel import ensemble, halo, mesh as pmesh  # noqa: E402
from cloudy_tpu_torch.spec import Family, SpectrumSpec  # noqa: E402

NORMS = (1e6, 1e-9)


def flagship(nz):
    """tests/test_parallel.py's `_flagship`: two gamma modes, Golovin 5.0,
    threshold 5e-10, the default tier."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=NORMS)
    config = rs.RainshaftConfig(spec=spec, nz=nz, zmax=3000.0, norms=NORMS, dt=1.0)
    return spec, data, config


def global_state(config, n_col):
    """De-correlated columns over the GLOBAL column index."""
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    return np.tile(ic[None], (n_col, 1, 1)) * np.linspace(0.5, 1.5, n_col)[:, None, None]


def unsharded_step(rhs, y, dt=1.0):
    return stepper.ssprk33_step(rhs, y, torch.zeros((), dtype=y.dtype), dt)


def case_column(rank, world, out):
    """tests/test_distributed.py's worker: a column-sharded AoS step with the
    all-mode mass diagnostic, 8 columns x 8 levels."""
    spec, data, config = flagship(8)
    rhs = rs.make_rainshaft_rhs(config, data)
    state = global_state(config, 8)
    state[..., 3:6] = 0.3 * state[..., 0:3]  # mass in mode 2 too
    n_loc = 8 // world
    local = torch.from_numpy(state[rank * n_loc:(rank + 1) * n_loc].copy())
    mesh = pmesh.make_mesh(("columns",))
    step = ensemble.ensemble_rainshaft_step(rhs, config.dt, mesh, with_diagnostics=True,
                                            spec=spec)
    y1, total = step(local)
    np.savez(out, y1=y1.numpy(), total=total.numpy(),
             local_step=unsharded_step(rhs, local).numpy())
    try:
        ensemble.ensemble_rainshaft_step(rhs, config.dt, mesh, with_diagnostics=True)
    except ValueError:
        pass
    else:
        raise AssertionError("with_diagnostics without spec did not raise")


def case_soa(rank, world, out):
    """The flat SoA routes over the column axis: the whole-step wrapper (its
    twin on the CPU) and the fused-RHS route (B4's twin + the torch
    stencil) through `ensemble_rainshaft_step_soa`, 16 columns x 16 levels,
    f64; a shard that is not whole columns raises."""
    from cloudy_tpu_torch.ops import fused_coalescence as fc

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=NORMS, fast_tier=True)
    config = rs.RainshaftConfig(spec=spec, nz=16, zmax=3000.0, norms=NORMS, dt=1.0)
    mesh = pmesh.make_mesh(("columns",))
    whole = fc.make_rainshaft_step_fn(data, config.vel, config.norms, nz=16, dz=config.dz,
                                      dt=1.0, device="cpu", dtype=torch.float64)
    fused = fc.make_rainshaft_rhs_fn(data, config.vel, config.norms, device="cpu",
                                     dtype=torch.float64)
    rhs = rs.make_rainshaft_rhs_fused(config, fused)
    n_loc = 16 // world
    soa = rs.to_soa(torch.from_numpy(global_state(config, 16)[rank * n_loc:(rank + 1) * n_loc]))
    y_whole = ensemble.ensemble_whole_step(whole, mesh)(soa)
    y_fused = ensemble.ensemble_rainshaft_step_soa(rhs, 1.0, mesh, nz=16)(soa)
    raised = []
    for fn in (ensemble.ensemble_whole_step(whole, mesh),
               ensemble.ensemble_rainshaft_step_soa(rhs, 1.0, mesh, nz=16)):
        try:
            fn(soa[:, :24].contiguous())
        except ValueError:
            raised.append(True)
    assert raised == [True, True], raised
    np.savez(out, whole=y_whole.numpy(), fused=y_fused.numpy())


def case_zhalo(rank, world, out):
    """The z-split step on a mesh ("columns", "z") of (1, world), 8 columns x
    16 levels, f64, and the order of the halo's receive and the
    coalescence on the rank that receives."""
    spec, data, config = flagship(16)
    mesh = pmesh.make_mesh(("columns", "z"), (1, world))
    events = []
    post = dist.irecv

    def irecv(*a, **k):
        events.append("irecv")
        return post(*a, **k)

    coal = halo.get_coal_ints

    def get_coal_ints(*a, **k):
        events.append("coal")
        return coal(*a, **k)

    dist.irecv = irecv
    halo.get_coal_ints = get_coal_ints
    try:
        rhs = halo.make_z_sharded_rainshaft_rhs(spec, data, config.dz, config.vel, NORMS,
                                                mesh=mesh, axis_name="z")
        nz_loc = 16 // world
        state = torch.from_numpy(global_state(config, 8))
        block = state[:, rank * nz_loc:(rank + 1) * nz_loc].contiguous()
        y1 = halo.z_sharded_step(rhs, config.dt, mesh)(block)
    finally:
        dist.irecv, halo.get_coal_ints = post, coal
    halo_top = halo.halo_from_above(block, mesh, "z", fill=-1.0)
    np.savez(out, y1=y1.numpy(), halo=halo_top.numpy(),
             events=np.asarray(events[:2]))


def case_mesh(rank, world, out):
    """`make_mesh` over the group, its axis sizes checked; a second
    `initialize_distributed` reports the group it finds."""
    m = pmesh.make_mesh(("columns", "z"), (world, 1))
    got = {"sizes": [m["columns"].size(), m["z"].size()],
           "local_rank": m.get_local_rank("columns"),
           "again": pmesh.initialize_distributed(),
           "world": list(pmesh.world())}
    try:
        pmesh.make_mesh(("columns",), (world + 1,))
    except ValueError as e:
        got["bad_sizes"] = str(e)
    with open(out, "w") as f:
        json.dump(got, f)


def case_sweep(rank, world, out):
    """The weak-scaling sweep at 1 and 2 ranks, 8 columns per rank x 8
    levels, the AoS RHS, 2 steps per chain."""
    from cloudy_tpu_torch.parallel import scaling

    spec, data, config = flagship(8)
    rhs = rs.make_rainshaft_rhs(config, data)
    recs = scaling.scaling_sweep(rhs, 1.0, 8, 6, columns_per_device=8, device="cpu",
                                 n_steps=2)
    with open(out, "w") as f:
        json.dump(recs, f)


def case_harness(rank, world, out):
    """The pod scenario through the harness's sharded route at 8 columns:
    a plain run (state, report), then a checkpointed one cut after its
    first segment and resumed, with an output directory; then a resume at
    16 columns over that directory (refused)."""
    from cloudy_tpu_torch import harness

    d = os.path.dirname(out)
    state, rep = harness.run_scenario("pod_ensemble", device="cpu", n_columns=8)
    ckd = os.path.join(d, "ckpt")
    cut, cut_rep = harness.run_scenario("pod_ensemble", device="cpu", n_columns=8,
                                        ckpt_dir=ckd, segment=40, max_segments=1)
    assert cut is None and cut_rep["n_steps_run"] == 40, cut_rep
    res, res_rep = harness.run_scenario("pod_ensemble", device="cpu", n_columns=8,
                                        ckpt_dir=ckd, segment=40,
                                        outdir=os.path.join(d, "out"))
    try:  # a checkpoint of another width: every rank refuses it
        harness.run_scenario("pod_ensemble", device="cpu", n_columns=16, ckpt_dir=ckd,
                             segment=40)
        refused = False
    except ValueError:
        refused = True
    np.savez(out, state=state.numpy(), resumed=res.numpy())
    with open(out + ".json", "w") as f:
        json.dump({"plain": rep, "resumed": res_rep, "refused": refused}, f)


def launch(case, outdir, world=2, timeout=120):
    """Run `case` on `world` gloo ranks (one process each, a free local
    port) and return the ranks' outputs; raises with a rank's output if it
    failed."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__), case,
                               str(port), str(r), str(world), str(outdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"OK {case} rank={r}" not in text:
            raise AssertionError(f"rank {r} of {case} failed ({p.returncode}):\n{text}")
    return outs


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main():
    case, port, rank, world, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    is_multi = pmesh.initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                            device="cpu")
    assert is_multi == (world > 1) and pmesh.world() == (world, rank), pmesh.world()
    assert dist.get_backend() == "gloo"
    ext = ".json" if case in ("mesh", "sweep") else ".npz"
    try:
        CASES[case](rank, world, os.path.join(outdir, f"{case}_rank{rank}{ext}"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"OK {case} rank={rank}", flush=True)


if __name__ == "__main__":
    main()
