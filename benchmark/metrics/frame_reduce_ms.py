"""Device ms per frame of the column-mean reduction: the activities
launched under the span around `harness.column_mean`, per call."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.calls("column_mean") or not tr.device:
        return None
    return tr.device_us_under("column_mean") / tr.calls("column_mean") / 1e3
