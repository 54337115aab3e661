"""On the card, at each cell's own size: a short run of every cell is
correct, and the control fails a limit on three seeds. Run on a machine
with the card:

    python -m pytest benchmark/tests -m cuda -q
"""

import pytest
import torch

from benchmark.tests.support import load_bench

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in load_bench()["workloads"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(workload):
    _need_card()
    from benchmark import run

    r = run.run_cell(workload, 2**32 + 17, 2.0, False, "cuda")
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card(workload):
    _need_card()
    from benchmark import control

    *recs, summary = control.readings(workload, [], [2**32 + 1, 2**32 + 2, 2**32 + 3], 2.0)
    limits = summary["summary"]
    for rec in recs:
        assert any(not v <= limits[k]["limit"] for k, v in rec["gaps"].items()), rec
