"""Host ms a round in ``round.local_sgd``: the cohort's local SGD."""
from fedbench.harness.readers import span_ms_per_unit


def read(trace, ctx):
    return span_ms_per_unit(trace, ctx, "round.local_sgd")
