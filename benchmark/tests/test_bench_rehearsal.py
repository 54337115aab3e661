"""The harness rehearsed end to end on the CPU at a tiny size (the port's
wrappers run their plain twins there), and a cell, a configuration, a mix
and a metric added by files alone."""

import hashlib
import importlib.util
import json
import shutil

import pytest

from benchmark.tests.support import ROOT, TINY_TRAFFIC, cpu_run, load_bench

CELLS = [w["name"] for w in load_bench()["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_end_to_end(bench, workload, trace):
    from benchmark import run

    r = cpu_run(bench, workload, trace=trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    names = {m["name"] for m in run.metrics_of(bench, workload, trace)}
    if not trace:  # the CPU has no device trace: the per-layer metrics stay out
        assert set(r["metrics"]) == names
    json.dumps(r, allow_nan=False)


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and metric in a copy of the
    benchmark: found by name, no file that was there edited but for the
    new entries in BENCHMARK.json."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")

    def digests():
        return {str(p.relative_to(tmp_path)): hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(tmp_path.rglob("*")) if p.is_file()}

    before = digests()
    del before["BENCHMARK.json"]  # takes the new entries
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "pod_fixed2gamma.json").read_text())
    cfg["name"] = "pod_wide"
    (b / "configs" / "pod_wide.json").write_text(json.dumps(cfg))
    traffic = {**json.loads((b / "traffic" / "frames10.json").read_text()),
               **TINY_TRAFFIC["pod_fixed2gamma.frames10"], "frames_per_job": 1}
    (b / "traffic" / "one_frame.json").write_text(json.dumps(traffic))
    (b / "metrics" / "jobs_per_s.py").write_text(
        '"""Jobs completed per second of the window."""\n\n\n'
        'def read(ctx):\n    return ctx.window["attempted"] / ctx.window["window_s"]\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "pod_wide",
                             "file": "benchmark/configs/pod_wide.json"})
    bench["workloads"].append({"name": "pod_wide.one_frame", "config": "pod_wide",
                               "traffic": "one_frame", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("column_updates_per_s", "frame_ms_p95"):
            m["workloads"].append("pod_wide.one_frame")
    bench["end_to_end"].append({"name": "jobs_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["pod_wide.one_frame"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = importlib.util.spec_from_file_location("copied_run", b / "run.py")
    copied = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copied)
    r = copied.run_cell("pod_wide.one_frame", 77, 0.01, False, "cpu")
    assert r["correct"] is True
    assert set(r["metrics"]) == {"jobs_per_s", "column_updates_per_s", "frame_ms_p95", "setup_s"}
    after = digests()
    assert all(after[k] == v for k, v in before.items())
