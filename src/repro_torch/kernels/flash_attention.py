"""Causal GQA flash attention: the CUDA kernel's wrapper (port of
``repro.kernels.flash_attention.flash_attention``).

The kernel is ``csrc/flash_attention.cu``: in bf16 a Hopper kernel on the
tensor cores (one CTA per 128 queries of one head, K/V tiles of 128 keys
brought by TMA into a two-stage ring, ``wgmma`` for both products, online
softmax in f32 registers); in f32 a CUDA-core kernel (64 x 64 tiles, f32
FMAs), since TF32 ``wgmma`` would not hold f32's tolerance. Head widths
64, 80, 112 and 128 have instances (in bf16, 80 and 112 run P V at the width
padded to 128, TMA zero-filling the columns past hd); any other width
raises. Its plain version is ``kernels/ref.py::flash_attention_ref``. A CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0

HEAD_DIMS = (64, 80, 112, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel: q ``[B,T,H,hd]``, k and v ``[B,S,Hkv,hd]`` (f32 or
    bf16, one dtype, one CUDA device; Hkv divides H; hd in ``HEAD_DIMS``) ->
    ``[B,T,H,hd]`` in q's dtype. Positions count from 0 for both q and k;
    ``window`` keeps keys with ``k_pos > q_pos - window``."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if (q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,T,H,hd] and k, v [B,S,Hkv,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, H, hd = q.shape
    _, S, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head width")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} has no kernel instance "
                         f"(built: {HEAD_DIMS})")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{Hkv} kv heads do not divide {H} query heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if S < 1 or max(B, T, S, H) >= 2 ** 31 or max(B, H) > 65535:
        raise ValueError(f"shape out of range: B={B} T={T} S={S} H={H}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if B * T * H == 0:
        return out
    # TMA reads from a 16-byte aligned base: a view that starts elsewhere is
    # copied (a fresh allocation is aligned), never sent to the plain version
    q, k, v = (x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    fn = build.kernel("flash_attention")
    with build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                T, S, H, Hkv, hd, int(bool(causal)), int(window or 0),
                build.DTYPE_CODES[q.dtype], stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out
