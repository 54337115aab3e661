"""Host us per launch of the program's kernel: the host clock around the
enqueue of each frame in the window of a traced run, over the launches the
kernel's wrapper counted there (its `launches`)."""


def read(ctx):
    d = ctx.window.get("dispatch") or {}
    if ctx.trace is None or not d.get("launches"):
        return None
    return 1e6 * d["host_s"] / d["launches"]
