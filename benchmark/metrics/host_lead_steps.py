"""The host's lead over the device, in whole steps: the median, over the
traced stretch's whole-step kernels (the activities launched under `b1`),
of how many earlier ones were still to end on the device when the program
``launch`` span that launched it ended. A faster kernel leaves it as it is
while the host keeps ahead; it falls toward 0 where the device waits for
the host. Counting kernels, it takes no harm from the tens of us to which
the device's timestamps sit on the host's clock."""

import statistics

from benchmark.core import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    ahead = [] if ps is None else ps.queued_ahead()
    return statistics.median(ahead) if ahead else None
