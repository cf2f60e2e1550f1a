"""The round's model FLOPs (VGG16's forward and backward over every local
sample) over its time and the chip's f32 peak."""
from fedbench.harness.readers import mfu_pct


def read(trace, ctx):
    return mfu_pct(trace, ctx)
