"""The benchmark's own tests: the plain reference against the port's
plain twins, the operation counts, the harness rehearsed end to end on the
CPU at a tiny size, the control and the planted faults. Run from the root
of the checkout:

    python -m pytest benchmark/tests -q

The tests marked ``cuda`` run on a CUDA card and skip without one.
"""

import pytest

from benchmark.tests.support import load_bench


@pytest.fixture
def bench():
    """BENCHMARK.json as committed (the tiny size is in the traffic,
    support.TINY_TRAFFIC)."""
    return load_bench()
