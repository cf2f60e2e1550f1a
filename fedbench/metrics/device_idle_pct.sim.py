"""Share of the traced window in which no operation ran on the device."""
from fedbench.harness.readers import idle_pct


def read(trace, ctx):
    return idle_pct(trace, ctx)
