"""Host-side set-up of the port equals the JAX package's bit for bit: the
fitted kernel tensors and every array of `CoalescenceData`, for the pod
variants and the golden box configurations; `from_numpy` carries a JAX
`CoalescenceData` into the port unchanged."""

import dataclasses

import numpy as np
import pytest

from cloudy_tpu import harness as jharness
from cloudy_tpu import kernels as JK
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.spec import SpectrumSpec as JSpec

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data, from_numpy
from cloudy_tpu_torch.spec import Family, SpectrumSpec

NORMS = (1e6, 1e-9)
_ARRAYS = ("wb", "wf", "kernels", "thresholds")


def _fields(d):
    return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}


def _assert_same(jd, d):
    for name in _ARRAYS:
        assert np.array_equal(getattr(jd, name), getattr(d, name)), name
    assert tuple(jd.n_2d_ints) == tuple(d.n_2d_ints)
    assert jd.n_points_max == d.n_points_max
    for name in ("P", "M", "n_mom_max", "moving", "gammainc_iters", "f2_exact",
                 "gammainc_gl_nodes", "lognorm_gl_nodes"):
        assert getattr(jd, name) == getattr(d, name), name
    assert tuple(int(f) for f in jd.spec.families) == tuple(int(f) for f in d.spec.families)


@pytest.mark.parametrize(
    "kfn",
    [("linear", 5.0), ("constant", 2e-10), ("long", (5.236e-10, 9.44e9, 5.78)),
     ("hydro", 1.0)],
    ids=lambda k: k[0],
)
def test_coalescence_tensor_from_function_equal(kfn):
    name, arg = kfn
    make = {
        "linear": lambda m: m.LinearKernelFunction(arg),
        "constant": lambda m: m.ConstantKernelFunction(arg),
        "long": lambda m: m.LongKernelFunction(*arg),
        "hydro": lambda m: m.HydrodynamicKernelFunction(arg),
    }[name]
    for order in (0, 1, 2):
        want = JK.CoalescenceTensor.from_function(make(JK), order, 1e-6).array
        got = K.CoalescenceTensor.from_function(make(K), order, 1e-6).array
        assert np.array_equal(want, got), (name, order)


@pytest.mark.parametrize("variant", sorted(jharness.POD_VARIANTS))
def test_pod_variant_data_equal(variant):
    fams, thresholds, moving, kw = jharness.POD_VARIANTS[variant]
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    jd = jbuild(JSpec(fams), jker, thresholds, norms=NORMS, moving=moving,
                fast_tier=True, **kw)
    d = build_coalescence_data(SpectrumSpec(tuple(Family(int(f)) for f in fams)),
                               ker, thresholds, norms=NORMS, moving=moving,
                               fast_tier=True, **kw)
    _assert_same(jd, d)


@pytest.mark.parametrize("name", ["box_single_gamma_golovin", "box_exp_gamma_mixture"])
def test_golden_box_data_equal(name):
    """The two golden box scenarios (cloudy_tpu/harness.py:28-75), rebuilt
    by the port from the same kernel functions and thresholds."""
    jd = jharness.SCENARIOS[name]()["data"]
    spec = SpectrumSpec(tuple(Family(int(f)) for f in jd.spec.families))
    lin = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    if name == "box_single_gamma_golovin":
        d = build_coalescence_data(spec, lin, (np.inf,), norms=NORMS)
    else:
        const = K.CoalescenceTensor.from_function(K.ConstantKernelFunction(2e-10), 1, 1e-6)
        d = build_coalescence_data(spec, K.CoalescenceTensor(const.array + lin.array),
                                   (5e-10, np.inf), norms=NORMS)
    _assert_same(jd, d)


def test_from_numpy_round_trip():
    fams, thresholds, moving, kw = jharness.POD_VARIANTS["fixed2gamma"]
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    jd = jbuild(JSpec(fams), jker, thresholds, norms=NORMS, fast_tier=True)
    d = from_numpy(_fields(jd))
    _assert_same(jd, d)
    assert isinstance(d.spec, SpectrumSpec)
    again = from_numpy(dataclasses.asdict(d))
    _assert_same(d, again)
