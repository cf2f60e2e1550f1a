"""The port's kernels in the round (the decode's scatter-add, the pair
masks): their least time over their device time."""
from fedbench.harness.readers import roofline_pct


def read(trace, ctx):
    return roofline_pct(trace, ctx)
