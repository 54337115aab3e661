"""The whole-step kernel's (B1's) share of its roofline, in %: the least
time the card could take for one launch over the device time per launch."""

from benchmark.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "b1")
