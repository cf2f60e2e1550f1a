"""Host ms a round in ``round.decode``: the streams' scatter-add."""
from fedbench.harness.readers import span_ms_per_unit


def read(trace, ctx):
    return span_ms_per_unit(trace, ctx, "round.decode")
