"""Seconds from the start of the process to the start of the window:
imports, the card's context, the build or load of the generated units,
the inputs made from the seed, the warm-up of every shape."""


def read(ctx):
    return ctx.setup_s
