"""The span recorder (`utils.metrics.span`) and the spans the port opens:
``launch`` around each kernel launch (`ops.fused_coalescence._launching`)
and ``column_mean`` around each frame's reduction (`harness.column_mean`).
The recorder is on while a `torch.profiler` session runs. The card's test
is marked ``cuda`` and skips without one; the file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_trace.py
"""

import itertools
import threading
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudy_tpu_torch import harness
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.utils import metrics

torch.set_num_threads(1)

VEL = ((50.0, 1.0 / 6.0),)
NORMS = (1e6, 1e-9)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """Each test starts and leaves the recorder empty."""
    metrics.take_spans()
    yield
    metrics.take_spans()


def _recording():
    """A profiler session, which switches the recorder on."""
    return profile(activities=[ProfilerActivity.CPU])


def _off_spans(n: int) -> None:
    for _ in itertools.repeat(None, n):  # no int objects of its own
        with metrics.span("launch"):
            pass


def test_off_records_nothing_and_returns_one_null_context(monkeypatch):
    assert not metrics.recording()
    assert metrics.span("launch") is metrics.span("column_mean", B=4)
    with metrics.span("launch") as attrs:
        assert attrs is None

    def no_clock():
        raise AssertionError("the recorder read the clock while off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    _off_spans(100)
    assert metrics.take_spans() == []


def test_off_keeps_no_memory():
    """Ten thousand spans while off hold no memory afterwards, and the peak
    does not grow with their number."""
    _off_spans(10)
    tracemalloc.start()
    try:
        _off_spans(1)
        _, peak_one = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        _off_spans(10_000)
        held, peak_many = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert held == 0 and peak_many <= peak_one


def test_spans_nest_and_clear_on_read():
    with _recording():
        with metrics.span("job"):
            with metrics.span("launch", B=64) as attrs:
                with metrics.span("unit", label="u"):
                    pass
                attrs["label"] = "k"
            with metrics.span("column_mean"):
                pass
    spans = metrics.take_spans()
    assert [s.name for s in spans] == ["job", "launch", "unit", "column_mean"]
    assert spans[1].attrs == {"B": 64, "label": "k"} and spans[2].attrs == {"label": "u"}
    assert spans[0].start_ns <= spans[1].start_ns <= spans[2].start_ns
    assert spans[2].end_ns <= spans[1].end_ns <= spans[3].start_ns <= spans[0].end_ns
    assert metrics.take_spans() == []


def test_a_thread_records_its_spans_too():
    def work():
        with metrics.span("column_mean"):
            pass

    with _recording():
        with metrics.span("job"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert sorted(s.name for s in metrics.take_spans()) == ["column_mean", "job"]


def test_a_profiler_session_switches_the_recorder_on():
    with metrics.span("launch"):
        pass
    with _recording():
        assert metrics.recording()
        with metrics.span("column_mean"):
            pass
    assert not metrics.recording()
    assert [s.name for s in metrics.take_spans()] == ["column_mean"]


def test_the_recorder_keeps_the_newest_spans_alone():
    """Spans nobody takes are bounded: past `MAX_SPANS` the oldest go."""
    with _recording():
        for i in range(metrics.MAX_SPANS + 3):
            with metrics.span("launch", i=i):
                pass
    spans = metrics.take_spans()
    assert len(spans) == metrics.MAX_SPANS
    assert spans[0].attrs == {"i": 3} and spans[-1].attrs == {"i": metrics.MAX_SPANS + 2}


def test_column_mean_records_one_span_per_call():
    y = torch.arange(2 * 12, dtype=torch.float64).reshape(2, 12)  # 3 columns of 4 levels
    with _recording():
        for _ in range(3):
            got = harness.column_mean(y, 4)
    assert [s.name for s in metrics.take_spans()] == ["column_mean"] * 3
    torch.testing.assert_close(got, y.reshape(2, 3, 4).mean(dim=1).T)


def _state(n_cols: int, nz: int) -> torch.Tensor:
    z = (np.arange(nz) + 0.5) * 3000.0 / nz
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2, 2e-12]),
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    return rs.to_soa(torch.as_tensor(np.tile(ic[None], (n_cols, 1, 1))))


def _pod_step(device, nz: int = 32):
    _, data = harness.pod_data("fixed2gamma")
    return fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=nz, dz=3000.0 / nz, dt=1.0,
                                     device=device, dtype=torch.float32)


def test_the_plain_twin_records_no_launch_span():
    fn = _pod_step("cpu", nz=4)
    with _recording():
        out = fn(_state(2, 4).float())
    assert metrics.take_spans() == [] and fn.launches == 0 and out.shape == (6, 8)


class _Counted(fc._KernelFn):
    """A wrapper whose entry point launches nothing but counts as having
    launched `label`, as a launch returning without error does."""

    @fc._launching
    def soa(self, mom, label):
        self._done(0, label, None)


def test_launch_spans_match_launches_and_carry_the_kernels_label():
    a, b = _Counted(None, "cpu", torch.float32), _Counted(None, "cpu", torch.float32)
    on_card = SimpleNamespace(device=torch.device("cuda", 0), shape=(6, 64))
    a.soa(on_card, "k1")  # with the recorder off
    with _recording():
        a.soa(on_card, "k1")
        b.soa(on_card, "k1")
        b.soa(on_card, "k2")
        b.soa(on_card, "k2")
    spans = metrics.take_spans()
    assert [s.name for s in spans] == ["launch"] * 4
    assert len(spans) == a.launches + b.launches - 1
    assert [s.attrs for s in spans] == [{"label": k} for k in ("k1", "k1", "k2", "k2")]
    assert a.kernel == "k1" and b.kernel == "k2"


@pytest.mark.cuda
def test_launch_spans_on_the_card():
    """A real launch of the pod's whole step: one ``launch`` span per
    launch the wrapper counts, each with the unit's label."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    fn = _pod_step("cuda")
    y = _state(64, 32).float().cuda()
    with _recording():
        for _ in range(5):
            y = fn(y)
        torch.cuda.synchronize()
    spans = metrics.take_spans()
    launch = [s for s in spans if s.name == "launch"]
    assert len(launch) == fn.launches == 5
    assert all(s.attrs == {"label": fn.unit.label} for s in launch)
    assert all(s.start_ns < s.end_ns for s in launch)
    assert bool(torch.isfinite(y).all())
