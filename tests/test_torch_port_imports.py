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


def test_import_without_jax():
    """Every module of the port imports in a process where importing jax or
    cloudy_tpu fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'cloudy_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import cloudy_tpu_torch, cloudy_tpu_torch.harness, cloudy_tpu_torch.bench\n"
        "import cloudy_tpu_torch.ops._build, cloudy_tpu_torch.ops.gauss\n"
        "import cloudy_tpu_torch.tools.profile_step\n"
        "assert not any(m.split('.')[0] in ('jax', 'cloudy_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


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
    assert coal.launches == 0 and step.launches == 0


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
    ["lognormal", "moving", "simpson_tier", "monodisperse"],
)
def test_unsupported_configuration_raises(case):
    if case == "lognormal":
        data = _data((Family.LOGNORMAL, Family.GAMMA), lognorm_gl_nodes=16)
    elif case == "moving":
        data = _data(thresholds=(0.9, 1.0), moving=True)
    elif case == "simpson_tier":
        data = _data(fast_tier=False)
    else:
        data = _data((Family.MONODISPERSE, Family.GAMMA))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fc.make_coal_fn(data, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fc.make_rainshaft_step_fn(data, ((50.0, 1.0 / 6.0),), NORMS, nz=32,
                                  dz=93.75, dt=1.0, device="cpu")


def test_packed_config_layout():
    """The byte buffer's header, per-mode ints, index tables and reals sit
    where csrc/coal_body.cuh reads them."""
    plan = fc.build_plan(_data(), ((50.0, 1.0 / 6.0),), NORMS, nz=32,
                         dz=93.75, dt=1.0)
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        buf = fc.pack_config(plan, dtype)
        assert buf.size % 16 == 0 and buf.size <= fc.CFG_MAX_BYTES
        ints = buf.view(np.int32)
        assert list(ints[:7]) == [2, 6, 4, 12, len(plan.wb_nz),
                                  len(plan.wf_nz), 1]
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
                   + len(plan.wf_nz) + 6 + 2 * 12 + 3)
        assert reals[n_reals - 3] == real_t(1.0)  # dt
        assert reals[n_reals - 2] == real_t(1.0 / 93.75)  # inv_dz, host double
        assert reals[0] == real_t(0.5)  # normalized threshold of mode 0
