"""Fixed-width bit packing of the stream wire: the CUDA kernels' wrappers
(port of ``repro.kernels.pack.bitpack_rows`` / ``bitunpack_rows``).

The kernels are ``csrc/bitpack.cu``: a CTA packs or unpacks one tile of
1,024 fields (32 chunks, ``32*w`` words) of one row (pack stages it in shared
memory), and one launch takes up to 8 segments (independent ``[R, k]``
arrays, each at its own width). Their plain versions are ``kernels/ref.py::bitpack_rows_ref`` /
``bitunpack_rows_ref`` and the segmented ``bitpack_segments_ref`` /
``bitunpack_segments_ref``. A CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.

The segmented wrappers, which the codec path calls, take and return int32
lanes holding the uint32 bits, so no cast runs around the launch; each
returns its arrays as views into one buffer, every view starting on a
16-byte boundary. ``bitpack_rows_cuda`` / ``bitunpack_rows_cuda`` are their
one-segment case with int64 lanes holding uint32 values, as the plain
versions take and return.
``pack_launches`` and ``unpack_launches`` count kernel launches and nothing
else: one per wrapper call with work, however many segments it takes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

pack_launches = 0
unpack_launches = 0

_ALIGN = 4        # int32 lanes: each segment's output starts on 16 bytes


def _check(x: torch.Tensor, name: str, width: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name} needs a [rows, n] tensor, got shape "
                         f"{tuple(x.shape)}")
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in 1..32, got {width}")


def _outputs(shapes, device) -> list:
    """Views ``[R_i, n_i]`` (int32) into one buffer, each 16-byte aligned."""
    offsets, total = [], 0
    for R, n in shapes:
        offsets.append(total)
        total += -(-R * n // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.int32, device=device)
    return [buf.as_strided((R, n), (n, 1), o)
            for o, (R, n) in zip(offsets, shapes)]


def _launch(entry: str, srcs, outs, ks, widths, words, device) -> bool:
    """One segmented launch over the segments with work; False if none."""
    desc = []
    for src, out, k, w, W in zip(srcs, outs, ks, widths, words):
        if src.shape[0] and k:
            desc += [src.data_ptr(), out.data_ptr(), src.shape[0], k, w, W]
    if not desc:
        return False
    fn = build.kernel(entry)
    with build.on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(fn((ctypes.c_longlong * len(desc))(*desc),
                       len(desc) // 6, stream), entry)
    return True


def bitpack_segments_cuda(fields, widths) -> list:
    """Launch the pack kernel once for up to 8 segments: ``[R_i, k_i]``
    fields (uint32 bits as int32 lanes; other integer dtypes are cast; the
    low ``w_i`` bits taken) on a CUDA device -> ``[R_i, ceil(k_i*w_i/32)]``
    words as int32 lanes holding the uint32 bits."""
    global pack_launches
    ref.check_segments(fields, widths, "bitpack_segments_cuda")
    for u, w in zip(fields, widths):
        _check(u, "bitpack_segments_cuda", w)
    srcs = [ref.i32_bits(u) for u in fields]
    ks = [u.shape[1] for u in srcs]
    words = [ref.packed_words(k, w) for k, w in zip(ks, widths)]
    outs = _outputs([(u.shape[0], W) for u, W in zip(srcs, words)],
                    srcs[0].device)
    if _launch("bitpack_segments", srcs, outs, ks, widths, words,
               srcs[0].device):
        pack_launches += 1
    return outs


def bitunpack_segments_cuda(words, ks, widths) -> list:
    """Launch the unpack kernel once for up to 8 segments: ``[R_i, W_i]``
    words (uint32 bits as int32 lanes; other integer dtypes are cast) on a
    CUDA device -> ``[R_i, k_i]`` fields as int32 lanes, each below
    ``2**w_i`` as uint32."""
    global unpack_launches
    ref.check_segments(words, widths, "bitunpack_segments_cuda")
    if len(ks) != len(words):
        raise ValueError(f"bitunpack_segments_cuda needs one k per array, "
                         f"got {len(ks)} for {len(words)}")
    for x, k, w in zip(words, ks, widths):
        _check(x, "bitunpack_segments_cuda", w)
        if 32 * x.shape[1] < k * w:
            raise ValueError(f"{x.shape[1]} words hold fewer than {k} "
                             f"fields of {w} bits")
    srcs = [ref.i32_bits(x) for x in words]
    outs = _outputs([(x.shape[0], k) for x, k in zip(srcs, ks)],
                    srcs[0].device)
    if _launch("bitunpack_segments", srcs, outs, ks, widths,
               [x.shape[1] for x in srcs], srcs[0].device):
        unpack_launches += 1
    return outs


def bitpack_rows_cuda(u: torch.Tensor, width: int) -> torch.Tensor:
    """Launch the pack kernel on one segment: ``[R, k]`` fields (uint32
    values in any integer dtype, low ``width`` bits taken) on a CUDA device
    -> ``[R, ceil(k*width/32)]`` words as int64 lanes holding uint32
    values."""
    return bitpack_segments_cuda([u], [width])[0].to(torch.int64) & ref.M32


def bitunpack_rows_cuda(words: torch.Tensor, k: int,
                        width: int) -> torch.Tensor:
    """Launch the unpack kernel on one segment: ``[R, W]`` words (uint32
    values in any integer dtype) on a CUDA device -> ``[R, k]`` fields as
    int64 lanes, each below ``2**width``."""
    out = bitunpack_segments_cuda([words], [k], [width])[0]
    return out.to(torch.int64) & ref.M32
