"""Device ms per frame of the column-mean reduction, read inside the
program: the activities launched under the program's ``column_mean`` spans
(`harness.column_mean`), per span."""

from benchmark.core import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    calls = [] if ps is None else ps.spans.get("column_mean", [])
    return ps.device_us_under(calls) / len(calls) / 1e3 if calls else None
