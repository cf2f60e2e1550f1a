"""Counter-based pair-mask streams: the CUDA kernel's wrapper (port of
``repro.kernels.mask_prng.pair_mask_streams``).

The kernel is ``csrc/pair_mask_streams.cu``, one thread per (pair, counter)
slot; its plain version is ``kernels/ref.py::pair_mask_stream_ref``. A CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0


def pair_mask_streams_cuda(seeds: torch.Tensor, signs: torch.Tensor, *,
                           nb: int, k_mask: int, m: int, p: float = -1.0,
                           q: float = 2.0):
    """Launch the kernel: ``seeds`` (uint32 values in any integer dtype)
    and f32 ``signs``, one per pair, on one CUDA device ->
    ``(idx int32[N, nb, k_mask], vals f32[N, nb, k_mask])``."""
    global launches
    if seeds.device.type != "cuda" or signs.device != seeds.device:
        raise ValueError("pair_mask_streams_cuda needs seeds and signs on one "
                         f"CUDA device, got {seeds.device} and {signs.device}")
    if seeds.dim() != 1 or signs.shape != seeds.shape:
        raise ValueError(f"need seeds[N] and signs[N], got "
                         f"{tuple(seeds.shape)} and {tuple(signs.shape)}")
    if not 1 <= m < 2 ** 32:
        raise ValueError(f"m must be in [1, 2**32), got {m}")
    n = seeds.shape[0]
    L = nb * k_mask
    s32 = (seeds.to(torch.int64) & ref.M32).to(torch.int32).contiguous()
    sg = signs.to(torch.float32).contiguous()
    idx = torch.empty((n, nb, k_mask), dtype=torch.int32, device=seeds.device)
    vals = torch.empty((n, nb, k_mask), dtype=torch.float32,
                       device=seeds.device)
    if n * L == 0:
        return idx, vals
    fn = build.kernel("pair_mask_streams")
    stream = torch.cuda.current_stream(seeds.device).cuda_stream
    rc = fn(s32.data_ptr(), sg.data_ptr(), n, L, m, float(p), float(q),
            idx.data_ptr(), vals.data_ptr(), stream)
    build.check(rc, "pair_mask_streams")
    launches += 1
    return idx, vals
