"""Host us per launch of the whole step inside the program: the mean
duration of the program's ``launch`` spans (the kernel wrapper's entry to
the return of its launch call) inside the benchmark's `b1` spans in the
traced stretch."""

from benchmark.core import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    durations = [] if ps is None else [b - a for a, b, _ in ps.b1_launches()]
    return sum(durations) / len(durations) if durations else None
