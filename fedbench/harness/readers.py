"""Arithmetic that several per-layer metrics share. A reader returns None
when its trace holds nothing for it to read."""
from __future__ import annotations

from fedbench.frozen import counts

# the device operations of each port kernel's launch, by name
KERNEL_OPS = {
    "stream_scatter_add": ("stream_scatter_add_split_kernel",
                           "stream_scatter_add_fold_kernel"),
    "pair_mask_streams": ("pair_mask_streams_kernel",),
}


def span_ms_per_unit(trace, ctx: dict, *names: str):
    """Host milliseconds of the named spans a round or step."""
    found = [trace.span_s(n) for n in names]
    if all(s is None for s in found) or not ctx["units"]:
        return None
    return 1e3 * sum(s for s in found if s is not None) / ctx["units"]


def roofline_pct(trace, ctx: dict):
    """Sum of the least time of every launch of the port's kernels in the
    window over the device time of those launches."""
    launched = ctx.get("launches") or []
    kernels = sorted({ln["kernel"] for ln in launched})
    if not kernels:
        return None
    ops = [op for k in kernels for op in KERNEL_OPS[k]]
    device_s = trace.device_s(*ops)
    if device_s <= 0:
        return None
    least = sum(counts.least_time_s(ln["bytes"], ln["flops"],
                                    ctx["peak_flops"]) for ln in launched)
    return 100.0 * least / device_s


def idle_pct(trace, ctx: dict):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu_pct(trace, ctx: dict):
    """Model FLOPs of the window's rounds or steps over its time and the
    chip's peak in the configuration's precision."""
    if not ctx["units"] or trace.window_s <= 0:
        return None
    return (100.0 * ctx["unit_flops"] * ctx["units"]
            / trace.window_s / ctx["peak_flops"])
