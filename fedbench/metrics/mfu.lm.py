"""The step's model FLOPs (6 N a token over the projection parameters, plus
causal attention) over its time and the chip's bf16 peak."""
from fedbench.harness.readers import mfu_pct


def read(trace, ctx):
    return mfu_pct(trace, ctx)
