"""Public kernel entry points: dispatch by the tensor's device (port of
``repro.kernels.ops``).

A CUDA tensor launches the hand-written CUDA kernel; a CPU tensor takes the
kernel's plain PyTorch version in ``kernels/ref.py``. There is no fallback
from one to the other: a CUDA launch that cannot build or launch raises.
``launch_counts()`` reads how often each kernel was launched, which is how a
run shows that it went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (flash_attention as flash, mask_prng, pack,
                                 ref, stream_decode, thgs_sparsify as thgs)

KERNELS = ("stream_scatter_add", "pair_mask_streams", "bitpack_rows",
           "bitunpack_rows", "flash_attention", "thgs_sparsify",
           "mask_prng_apply")


def stream_scatter_add(indices: torch.Tensor, values: torch.Tensor, *,
                       size: int) -> torch.Tensor:
    """Flat stream -> dense f32[size], each position folded in slot order."""
    if values.device.type == "cuda":
        return stream_decode.stream_scatter_add_cuda(indices, values, size)
    return ref.stream_scatter_add_ref(indices, values, size)


def pair_mask_streams(seeds: torch.Tensor, signs: torch.Tensor, *, nb: int,
                      k_mask: int, m: int, p: float = -1.0, q: float = 2.0):
    """Pair-mask streams of a flat list of pairs (Eq. 3-4): one seed and
    sign per pair -> ``(idx int32[N, nb, k_mask], vals f32)``; one segment
    of :func:`pair_mask_segments`' kernel on the card."""
    if seeds.device.type == "cuda":
        return mask_prng.pair_mask_streams_cuda(seeds, signs, nb=nb,
                                                k_mask=k_mask, m=m, p=p, q=q)
    return ref.pair_mask_stream_ref(seeds, signs, nb, k_mask, m, p=p, q=q)


def pair_mask_segments(seeds: torch.Tensor, signs: torch.Tensor, leaves, *,
                       p: float = -1.0, q: float = 2.0, mirror: bool = False,
                       alive: torch.Tensor | None = None) -> list:
    """Every leaf's pair-mask streams of a round from one ``[rows, peers]``
    seed and sign matrix, in ONE launch per 64 leaves on the card: each
    leaf ``(nb, k_mask, m, leaf_id or None)`` -> ``(idx int32, vals f32)``
    in the engine's per-client layout ``[rows, nb, peers * k_mask]``;
    ``mirror`` and ``alive`` (the recovery streams: gated, global indices,
    ``[rows * peers, nb, k_mask]``) as in ``ref.pair_mask_segments_ref``."""
    if seeds.device.type == "cuda":
        return mask_prng.pair_mask_segments_cuda(
            seeds, signs, leaves, p=p, q=q, mirror=mirror, alive=alive)
    return ref.pair_mask_segments_ref(seeds, signs, leaves, p=p, q=q,
                                      mirror=mirror, alive=alive)


def bitpack_rows(u: torch.Tensor, *, width: int) -> torch.Tensor:
    """Pack ``[R, k]`` fields of ``width`` bits into ``[R, ceil(k*width/32)]``
    uint32 words (int64 lanes), each row one LSB-first bit stream."""
    if u.device.type == "cuda":
        return pack.bitpack_rows_cuda(u, width)
    return ref.bitpack_rows_ref(u, width)


def bitunpack_rows(words: torch.Tensor, *, k: int,
                   width: int) -> torch.Tensor:
    """Inverse of :func:`bitpack_rows`: words -> ``[R, k]`` fields."""
    if words.device.type == "cuda":
        return pack.bitunpack_rows_cuda(words, k, width)
    return ref.bitunpack_rows_ref(words, k, width)


def bitpack_segments(fields, *, widths) -> list:
    """:func:`bitpack_rows` over up to 8 ``[R_i, k_i]`` field arrays, each
    at its own width, in ONE launch on the card; int32 lanes holding the
    uint32 bits in and out (the low ``w_i`` bits of each field taken)."""
    if any(u.device.type == "cuda" for u in fields):
        return pack.bitpack_segments_cuda(fields, widths)
    return ref.bitpack_segments_ref(fields, widths)


def bitunpack_segments(words, *, ks, widths) -> list:
    """Inverse of :func:`bitpack_segments`: up to 8 ``[R_i, W_i]`` word
    arrays -> ``[R_i, k_i]`` fields as int32 lanes, in ONE launch on the
    card."""
    if any(x.device.type == "cuda" for x in words):
        return pack.bitunpack_segments_cuda(words, ks, widths)
    return ref.bitunpack_segments_ref(words, ks, widths)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA attention ``[B,T,H,hd] x [B,S,Hkv,hd] -> [B,T,H,hd]`` with an
    f32 online softmax, causal and/or banded to ``window``.

    Forward only: the kernel has no backward, so inputs that require grad
    (with grad mode on) raise ``RuntimeError`` on every device, rather than
    give a result with no gradient on the card; training attends through
    ``models.attention.attend_chunked``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention has no backward: inputs that "
                           "require grad go through "
                           "models.attention.attend_chunked")
    if q.device.type == "cuda":
        return flash.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def thgs_sparsify(g: torch.Tensor, residual: torch.Tensor, threshold):
    """THGS threshold split: ``acc = g + residual`` in f32, ``sparse =
    acc * 1[|acc| > f32(threshold)]``, ``resid = acc - sparse``; returns
    ``(sparse, resid)`` in g's and residual's dtypes. ``threshold`` is a
    float or a one-element tensor on g's device."""
    if g.device.type == "cuda":
        return thgs.thgs_sparsify_cuda(g, residual, threshold)
    return ref.thgs_sparsify_ref(g, residual, threshold)


def mask_prng_apply(g: torch.Tensor, *, seed: int, p: float = -1.0,
                    q: float = 2.0, sigma: float, sign: float = 1.0):
    """Dense counter-based mask and apply (Eq. 3-5): ``(g + mask`` in g's
    dtype, ``mask`` f32), the mask regenerated from ``seed`` and the flat
    position, kept where ``u < sigma``."""
    if g.device.type == "cuda":
        return mask_prng.mask_prng_apply_cuda(g, seed, p=p, q=q, sigma=sigma,
                                              sign=sign)
    return ref.mask_prng_ref(g, seed, p=p, q=q, sigma=sigma, sign=sign)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {"stream_scatter_add": stream_decode.launches,
            "pair_mask_streams": mask_prng.launches,
            "bitpack_rows": pack.pack_launches,
            "bitunpack_rows": pack.unpack_launches,
            "flash_attention": flash.launches,
            "thgs_sparsify": thgs.launches,
            "mask_prng_apply": mask_prng.apply_launches}


def reset_launch_counts() -> None:
    stream_decode.launches = 0
    mask_prng.launches = 0
    pack.pack_launches = 0
    pack.unpack_launches = 0
    flash.launches = 0
    thgs.launches = 0
    mask_prng.apply_launches = 0
