"""The port's native golden model (`cloudy_tpu_torch.native`) on the CPU.

tests/test_native.py's three cases, the exp + gamma one included: the port
builds `native/cloudy_golden.cc` with the JAX package's g++ flags into
build/cloudy_tpu_torch/ and its `coal_ints_golden` takes the port's
`CoalescenceData`. Given the same arrays (the port's `build_coalescence_data`
gives JAX's bit for bit, checked here), the port's oracle equals JAX's
`native.coal_ints_golden` bit for bit, and it matches the port's
`get_coal_ints` to tests/test_native.py's rtol 1e-8. The build never writes
native/libcloudy_golden.so, which belongs to the JAX package.
"""

import dataclasses
import hashlib
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu import distributions as jpd
from cloudy_tpu import kernels as JK
from cloudy_tpu import native as jnative
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch import native
from cloudy_tpu_torch.coalescence import build_coalescence_data, get_coal_ints
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


def _both(families, fn_kernel, limit, thresholds, **kw):
    """(JAX data, port data) of one configuration; their arrays bit for bit."""
    jker = JK.CoalescenceTensor.from_function(fn_kernel(JK), 1, limit)
    ker = K.CoalescenceTensor.from_function(fn_kernel(K), 1, limit)
    jdata = jbuild(JSpec(tuple(JFamily(int(f)) for f in families)), jker, thresholds, **kw)
    data = build_coalescence_data(SpectrumSpec(families), ker, thresholds, **kw)
    for f in dataclasses.fields(data):
        a, b = getattr(jdata, f.name), getattr(data, f.name)
        if isinstance(b, np.ndarray):
            assert np.asarray(a).tobytes() == b.tobytes(), f.name
    return jdata, data


def _two_gamma_moments():
    """tests/test_native.py:24-37: parameters drawn, then mapped to moments."""
    rng = np.random.default_rng(3)
    B = 32
    params = np.stack([
        np.stack([rng.uniform(50, 200, B), rng.uniform(0.05, 0.2, B),
                  rng.uniform(0.5, 3.0, B)], -1),
        np.stack([rng.uniform(1e-4, 1e-2, B), rng.uniform(5, 20, B),
                  rng.uniform(0.5, 3.0, B)], -1),
    ], axis=1)
    return np.asarray(jpd.get_moments(JSpec((JFamily.GAMMA,) * 2), jnp.asarray(params)))


def test_golden_matches_jax_two_gamma():
    jdata, data = _both((Family.GAMMA, Family.GAMMA), lambda m: m.LinearKernelFunction(5.0),
                        1e-6, (5e-10, np.inf), norms=(1e6, 1e-9))
    mom = _two_gamma_moments()
    got = native.coal_ints_golden(data, torch.tensor(mom))
    assert got.tobytes() == jnative.coal_ints_golden(jdata, mom).tobytes()
    want = get_coal_ints(data, pd.params_from_moments(data.spec, torch.tensor(mom)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-8, atol=1e-12)


def test_golden_matches_jax_exp_gamma():
    jdata, data = _both((Family.EXPONENTIAL, Family.GAMMA),
                        lambda m: m.LinearKernelFunction(5e-3), 10.0, (0.5, np.inf))
    mom = np.array([[100.0, 10.0, 1.0, 1.0, 2.0]])
    got = native.coal_ints_golden(data, mom)
    assert got.tobytes() == jnative.coal_ints_golden(jdata, mom).tobytes()
    want = get_coal_ints(data, pd.params_from_moments(data.spec, torch.tensor(mom)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-8)


def test_golden_degenerate_zero():
    _, data = _both((Family.GAMMA, Family.GAMMA), lambda m: m.LinearKernelFunction(5.0),
                    1e-6, (5e-10, np.inf), norms=(1e6, 1e-9))
    got = native.coal_ints_golden(data, torch.zeros((4, 6), dtype=torch.float32))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, 0.0)


def test_golden_refuses_what_it_does_not_model():
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    lognorm = build_coalescence_data(SpectrumSpec((Family.LOGNORMAL, Family.GAMMA)), ker,
                                     (5e-10, np.inf), norms=(1e6, 1e-9))
    with pytest.raises(ValueError, match="LOGNORMAL"):
        native.coal_ints_golden(lognorm, np.ones((1, 6)))
    moving = build_coalescence_data(SpectrumSpec((Family.GAMMA, Family.GAMMA)), ker,
                                    (0.9, 1.0), norms=(1e6, 1e-9), moving=True)
    with pytest.raises(ValueError, match="FixedThreshold"):
        native.coal_ints_golden(moving, np.ones((1, 6)))


def test_build_leaves_the_jax_library_alone(tmp_path, monkeypatch):
    """The port's build goes to its own directory under a name that carries
    the source's digest; native/libcloudy_golden.so keeps its bytes and
    mtime."""
    jnative._load()  # the JAX package's own (re)build, if its library were stale, first
    jlib = native.SOURCE.parent / "libcloudy_golden.so"
    before = (jlib.stat().st_mtime_ns, hashlib.sha256(jlib.read_bytes()).hexdigest())
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    lib = native.build(force=True)
    assert lib.parent == tmp_path / "build" and lib.exists()
    digest = hashlib.sha256(native.SOURCE.read_bytes())
    digest.update(" ".join(native.GXX_FLAGS).encode())
    assert lib.name == f"libcloudy_golden_{digest.hexdigest()[:16]}.so"
    assert native.build() == lib  # found, not rebuilt
    assert not list((tmp_path / "build").glob("*.tmp"))
    assert (jlib.stat().st_mtime_ns, hashlib.sha256(jlib.read_bytes()).hexdigest()) == before
