"""Host ms a round in ``round.secagg_setup`` and ``round.encode``: the pair
seeds, the masks and the THGS encode."""
from fedbench.harness.readers import span_ms_per_unit


def read(trace, ctx):
    return span_ms_per_unit(trace, ctx, "round.secagg_setup", "round.encode")
