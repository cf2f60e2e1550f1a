"""Fixed-width bit packing of the stream wire: the CUDA kernels' wrappers
(port of ``repro.kernels.pack.bitpack_rows`` / ``bitunpack_rows``).

The kernels are ``csrc/bitpack.cu`` (pack: one thread per output word;
unpack: one thread per field); their plain versions are
``kernels/ref.py::bitpack_rows_ref`` / ``bitunpack_rows_ref``. A CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises. The
wrappers take and return int64 lanes holding uint32 values, as the plain
versions do; the kernels see the same bits as int32. ``pack_launches`` and
``unpack_launches`` count kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

pack_launches = 0
unpack_launches = 0


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in any integer dtype -> the same bits as int32."""
    if x.dtype != torch.int32:
        x = (x.to(torch.int64) & ref.M32).to(torch.int32)
    return x.contiguous()


def _check(x: torch.Tensor, name: str, width: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name} needs a [rows, n] tensor, got shape "
                         f"{tuple(x.shape)}")
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in 1..32, got {width}")


def bitpack_rows_cuda(u: torch.Tensor, width: int) -> torch.Tensor:
    """Launch the pack kernel: ``[R, k]`` fields (uint32 values in any
    integer dtype, low ``width`` bits taken) on a CUDA device ->
    ``[R, ceil(k*width/32)]`` words as int64 lanes holding uint32 values."""
    global pack_launches
    _check(u, "bitpack_rows_cuda", width)
    R, k = u.shape
    W = ref.packed_words(k, width)
    src = _u32_bits(u)
    out = torch.empty((R, W), dtype=torch.int32, device=u.device)
    if R * W:
        fn = build.kernel("bitpack_rows")
        stream = torch.cuda.current_stream(u.device).cuda_stream
        build.check(fn(src.data_ptr(), R, k, width, out.data_ptr(), W,
                       stream), "bitpack_rows")
        pack_launches += 1
    return out.to(torch.int64) & ref.M32


def bitunpack_rows_cuda(words: torch.Tensor, k: int,
                        width: int) -> torch.Tensor:
    """Launch the unpack kernel: ``[R, W]`` words (uint32 values in any
    integer dtype) on a CUDA device -> ``[R, k]`` fields as int64 lanes,
    each below ``2**width``."""
    global unpack_launches
    _check(words, "bitunpack_rows_cuda", width)
    R, W = words.shape
    if 32 * W < k * width:
        raise ValueError(f"{W} words hold fewer than {k} fields of "
                         f"{width} bits")
    src = _u32_bits(words)
    out = torch.empty((R, k), dtype=torch.int32, device=words.device)
    if R * k:
        fn = build.kernel("bitunpack_rows")
        stream = torch.cuda.current_stream(words.device).cuda_stream
        build.check(fn(src.data_ptr(), R, W, k, width, out.data_ptr(),
                       stream), "bitunpack_rows")
        unpack_launches += 1
    return out.to(torch.int64) & ref.M32
