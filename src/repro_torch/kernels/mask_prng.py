"""Counter-based pair masks: the wrappers of the two CUDA kernels in
``csrc/pair_mask_streams.cu`` (port of ``repro.kernels.mask_prng``).

``pair_mask_streams_cuda`` launches one thread per (pair, counter) slot (plain
version ``kernels/ref.py::pair_mask_stream_ref``); ``mask_prng_apply_cuda``
one thread per element of g (plain version ``ref.mask_prng_ref``). A CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
``launches`` and ``apply_launches`` count kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0
apply_launches = 0


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


def mask_prng_apply_cuda(g: torch.Tensor, seed: int, *, p: float = -1.0,
                         q: float = 2.0, sigma: float, sign: float = 1.0):
    """Launch the kernel: f32 or bf16 ``g`` of any shape on a CUDA device,
    a uint32 ``seed`` -> ``(g + mask`` in g's dtype, ``mask`` f32), both of
    g's shape."""
    global apply_launches
    if g.device.type != "cuda":
        raise ValueError(f"mask_prng_apply_cuda needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype not in build.DTYPE_CODES:
        raise ValueError("mask_prng_apply_cuda takes float32 or bfloat16, "
                         f"got {g.dtype}")
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    if g.numel() >= 2 ** 32:
        raise ValueError("the position counter is 32 bits: g needs fewer "
                         f"than 2**32 elements, got {g.numel()}")
    gc = g.contiguous()
    out = torch.empty_like(gc)
    mask = torch.empty(gc.shape, dtype=torch.float32, device=g.device)
    if g.numel() == 0:
        return out, mask
    fn = build.kernel("mask_prng_apply")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(gc.data_ptr(), g.numel(), int(seed), float(p), float(q),
            float(sigma), float(sign), build.DTYPE_CODES[g.dtype], out.data_ptr(),
            mask.data_ptr(), stream)
    build.check(rc, "mask_prng_apply")
    apply_launches += 1
    return out, mask
