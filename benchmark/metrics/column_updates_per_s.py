"""Column-steps completed in the window per second of the window (host
clock; the window ends with the read of the job in flight when the time was
up, so it holds whole jobs): one column advanced one SSPRK33 step."""


def read(ctx):
    return ctx.window["work"] / ctx.window["window_s"]
