"""The program's spans on a synthetic chrome trace: moved onto the trace's
clock by the benchmark's fit, the per-layer metrics read from them against
values computed by hand, idle gaps named with them, and every reader None
where the program recorded nothing."""

from types import SimpleNamespace

import pytest

from benchmark.core import program_spans
from benchmark.core.trace import Trace
from benchmark.run import load_plugin

OFF = 5000.0  # the trace's clock runs OFF + 1 us ahead of the host's


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts + OFF, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """Two whole-step launches and a reduction of a kernel and a memset;
    times below are the trace's less OFF, so the host's are one less."""
    first, last = [100.0, 110.0, 120.0], [1000.0, 1010.0, 1020.0]
    ev = [_x("cuda_runtime", "cudaDeviceSynchronize", t + 1.0, 2.0) for t in first + last]
    ev += [
        _x("cuda_runtime", "cudaLaunchKernel", 450.0, 5.0, 1), _x("kernel", "step", 500.0, 100.0, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 470.0, 3.0, 2), _x("kernel", "step", 600.0, 100.0, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 700.0, 5.0, 3), _x("kernel", "mean", 810.0, 50.0, 3),
        _x("cuda_runtime", "cudaMemsetAsync", 706.0, 2.0, 4), _x("gpu_memset", "Memset", 860.0, 10.0, 4),
    ]
    spans = [("job", 400.0, 900.0), ("b1", 439.0, 459.0), ("b1", 464.0, 479.0),
             ("column_mean", 689.0, 769.0)]
    return Trace(ev, spans, (130.0, 990.0), (first, last))


#: the program's spans on the host clock: (name, start us, end us, attrs)
PROGRAM = [("launch", 441.0, 456.0, {"label": "step_f32_x"}),
           ("launch", 466.0, 477.0, {"label": "step_f32_x"}),
           ("column_mean", 692.0, 760.0, {}),
           ("launch", 2000.0, 2010.0, {"label": "after the stretch"})]


def _ctx(monkeypatch, spans=PROGRAM, trace=None):
    monkeypatch.setattr(program_spans, "_take", lambda: list(spans))
    return SimpleNamespace(trace=trace if trace is not None else _trace())


def _read(name, ctx):
    return load_plugin("metrics", name).read(ctx)


def test_program_spans_take_the_benchmarks_fit():
    """A program span recorded at the host times of a benchmark span lands
    where the benchmark's span does; one outside the stretch is left out."""
    tr = _trace()
    ps = program_spans.ProgramSpans(tr, [("launch", 439.0, 459.0, {}),
                                         ("launch", 2000.0, 2010.0, {})])
    assert [s[:2] for s in ps.spans["launch"]] == [tr.spans["b1"][0]]
    assert tr.spans["b1"][0] == (440.0 + OFF, 460.0 + OFF)


def test_readers_on_hand_computed_values(monkeypatch):
    ctx = _ctx(monkeypatch)
    assert _read("launch_host_us", ctx) == pytest.approx((15.0 + 11.0) / 2)
    # kernels run 500-600 and 600-700; their launch spans end 457 and 478, the
    # first with none queued ahead of it, the second with the first
    assert _read("host_lead_steps", ctx) == pytest.approx(0.5)
    # the mean kernel and the memset, launched inside the one column_mean span
    assert _read("column_mean_ms", ctx) == pytest.approx((50.0 + 10.0) / 1e3)


def test_the_report_meets_the_trace(monkeypatch, capsys):
    ctx = _ctx(monkeypatch)
    ps = program_spans.of(ctx)
    assert program_spans.of(ctx) is ps  # taken once a stretch
    err = capsys.readouterr().err
    assert err.count("program spans:") == 1
    assert "2 of 2 b1 kernels" in err and "per job span launch [2], column_mean [1]" in err
    assert "under the program's b1 launch spans 100.000, under b1 100.000" in err
    assert "the runtime's launch call 4.0 us (2 calls)" in err


def test_an_idle_gap_inside_a_program_span_carries_its_name(monkeypatch):
    ps = program_spans.of(_ctx(monkeypatch))
    gaps = {round(d * 1e6, 6): name for name, d in ps.idle_gaps()}
    assert gaps[110.0] == "column_mean / column_mean / no host call"  # 700 to 810, in both
    assert gaps[369.0] == "outside any span / no host call"  # 131 to 500: before the job
    assert gaps[121.0] == "outside any span / no host call"  # 870 to 991
    assert list(gaps) == [369.0, 121.0, 110.0]


@pytest.mark.parametrize("name", ["launch_host_us", "host_lead_steps", "column_mean_ms"])
def test_readers_read_none_without_program_spans_or_a_device_trace(monkeypatch, name):
    assert _read(name, SimpleNamespace(trace=None)) is None
    assert _read(name, _ctx(monkeypatch, spans=[])) is None  # a program without the recorder
    no_device = Trace([], [], (0.0, 1.0))
    assert _read(name, _ctx(monkeypatch, trace=no_device)) is None  # the CPU's trace


def test_a_program_without_the_recorder_gives_no_spans(monkeypatch):
    from cloudy_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "take_spans")
    assert program_spans._take() == []
