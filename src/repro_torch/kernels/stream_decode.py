"""Slot-order stream scatter-add: the CUDA kernel's wrapper (port of
``repro.kernels.stream_decode.stream_scatter_add``).

The kernel is ``csrc/stream_scatter_add.cu``: the stream bucketed by output
tile in slot order, each tile's bucket folded by one CTA, zero values skipped
(exactly), no float atomics. Its plain version is
``kernels/ref.py::stream_scatter_add_ref``. A CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
calls that launched the kernel: one per call, although a call runs two
passes back to back on the current stream (a split of each chunk by output
tile, then a fold per tile), and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0


def stream_scatter_add_cuda(indices: torch.Tensor, values: torch.Tensor,
                            size: int) -> torch.Tensor:
    """Launch the kernel: flat int32 ``indices`` and f32 ``values`` on one
    CUDA device -> dense f32[size]; entries outside [0, size) dropped."""
    global launches
    if indices.device.type != "cuda" or values.device != indices.device:
        raise ValueError("stream_scatter_add_cuda needs indices and values on "
                         f"one CUDA device, got {indices.device} and "
                         f"{values.device}")
    if indices.numel() != values.numel():
        raise ValueError(f"indices ({indices.numel()}) and values "
                         f"({values.numel()}) must have one entry each")
    if not 0 <= size < 2 ** 31:
        raise ValueError(f"size must be in [0, 2**31), got {size}")
    if indices.numel() >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 stream entries, got "
                         f"{indices.numel()}")
    idx = indices.reshape(-1).to(torch.int32).contiguous()
    val = values.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty(size, dtype=torch.float32, device=indices.device)
    if size == 0:
        return out
    fn = build.kernel("stream_scatter_add")
    work = workspace(idx.numel(), size, indices.device)
    with build.on_device(indices.device):
        stream = torch.cuda.current_stream(indices.device).cuda_stream
        rc = fn(idx.data_ptr(), val.data_ptr(), idx.numel(), out.data_ptr(),
                size, work.data_ptr(), work.numel(), stream)
    build.check(rc, "stream_scatter_add")
    launches += 1
    return out


def workspace(n: int, size: int, device) -> torch.Tensor:
    """The scratch of one call on ``device`` (the ``[chunk][tile]`` run
    table, then each chunk's entries sorted by output tile), sized by the
    kernel's own C helper (``make_plan`` in the source)."""
    nbytes = build.kernel("stream_scatter_add_workspace_bytes")(n, size)
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
