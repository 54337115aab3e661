"""The trace's arithmetic on a synthetic chrome trace: the clocks matched
by the markers, device time under a span, the union of busy intervals,
the idle gaps named by the host."""

from benchmark.core.trace import Trace

OFF = 5000.0


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts + OFF, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    first, last = [100.0, 110.0, 120.0], [1000.0, 1010.0, 1020.0]
    ev = [_x("cuda_runtime", "cudaDeviceSynchronize", t + 1.0, 2.0) for t in first + last]
    ev.insert(0, _x("cuda_runtime", "cudaDeviceSynchronize", 90.0, 50.0))  # the profiler's own
    ev += [
        _x("cuda_runtime", "cudaLaunchKernel", 450.0, 5.0, 1), _x("kernel", "step", 500.0, 100.0, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 470.0, 5.0, 2), _x("kernel", "step", 590.0, 100.0, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 700.0, 5.0, 3), _x("kernel", "mean", 800.0, 50.0, 3),
        _x("cuda_runtime", "cudaStreamSynchronize", 730.0, 120.0),
    ]
    spans = [("b1", 440.0, 460.0), ("b1", 465.0, 480.0), ("column_mean", 690.0, 710.0),
             ("read", 720.0, 860.0)]
    return Trace(ev, spans, (130.0, 990.0), (first, last))


def test_clocks_matched_by_markers():
    tr = _trace()
    assert tr.to_trace(100.0) == 100.0 + OFF + 1.0
    assert tr.window == (131.0 + OFF, 991.0 + OFF)


def test_device_time_under_spans():
    tr = _trace()
    assert tr.calls("b1") == 2 and tr.device_us_under("b1") == 200.0
    assert tr.device_us_under("column_mean") == 50.0
    assert tr.device_us() == 250.0


def test_busy_is_a_union_and_gaps_are_named():
    tr = _trace()
    assert tr.busy_us() == 190.0 + 50.0  # [500, 690] and [800, 850]
    gaps = dict((round(d * 1e6, 6), name) for name, d in tr.idle_gaps(3))
    assert gaps[369.0] == "outside any span / no host call"  # from 131 to 500
    assert gaps[110.0] == "read / cudaStreamSynchronize"  # from 690 to 800
    assert tr.top_ops(1) == [["step", 200e-6]]
