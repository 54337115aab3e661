"""1 - the union of the device's activity intervals over the traced
stretch, as a fraction of the stretch."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.window_us() or not tr.device:
        return None
    return 1.0 - tr.busy_us() / tr.window_us()
