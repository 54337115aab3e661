"""The 95th percentile, in ms, of the time between consecutive frame ends
(CUDA events on the stream) over every frame of the window; a job's first
frame carries the host's gap after the previous job's read."""

from benchmark.core.clock import p95


def read(ctx):
    v = ctx.window["intervals"].get("frame")
    return 1e3 * p95(v) if v else None
