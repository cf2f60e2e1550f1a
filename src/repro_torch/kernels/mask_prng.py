"""Counter-based pair masks: the wrappers of the two CUDA kernels in
``csrc/pair_mask_streams.cu`` (port of ``repro.kernels.mask_prng``).

``pair_mask_segments_cuda`` makes every leaf's pair-mask streams of a round
in one launch of the pair-mask kernel (up to 64 leaves a launch): the leaf
seed fold, the triangle mirror, the signs, the recovery gate and the
engine's per-client layout are inside the kernel (plain version
``kernels/ref.py::pair_mask_segments_ref``). ``pair_mask_streams_cuda`` is
the flat per-pair call, a one-segment launch of the same kernel (plain
version ``ref.pair_mask_stream_ref``). ``mask_prng_apply_cuda`` launches one
thread per element of g (plain version ``ref.mask_prng_ref``). A CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
``launches`` and ``apply_launches`` count kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0
apply_launches = 0

MAX_SEGMENTS = 64      # a launch's segment table (csrc note: why 64)
_ALIGN = 4             # each segment's outputs start on 16 bytes
# the kernel's header flags
MIRROR, GATE, GLOBAL, PAIR_MAJOR = 1, 2, 4, 8


def _outputs(n_slots, device):
    """One int32 and one f32 buffer holding every segment, each segment's
    offset a multiple of 4 elements; returns the two buffers and the
    offsets."""
    offsets, total = [], 0
    for n in n_slots:
        offsets.append(total)
        total += -(-n // _ALIGN) * _ALIGN
    return (torch.empty(total, dtype=torch.int32, device=device),
            torch.empty(total, dtype=torch.float32, device=device), offsets)


def pair_mask_segments_cuda(seeds: torch.Tensor, signs: torch.Tensor,
                            leaves, *, p: float = -1.0, q: float = 2.0,
                            mirror: bool = False,
                            alive: torch.Tensor | None = None) -> list:
    """Launch the pair-mask kernel once per 64 leaves: ``seeds`` ``[rows,
    peers]`` (uint32 values in any integer dtype; int32 lanes holding the
    bits are taken as they are) and f32 ``signs`` of the same shape, on one
    CUDA device; ``leaves`` one ``(nb, k_mask, m, leaf_id or None)`` per
    segment. ``mirror`` reads the seed at ``(min(i, j), max(i, j))``.
    Returns one ``(idx int32, vals f32)`` per leaf, ``[rows, nb, peers *
    k_mask]`` (peer-major within a row): views into one int32 and one f32
    buffer. ``alive`` (``[rows]``, 0/1) makes the recovery streams: each
    value gated by ``-(alive[i] * (1 - alive[j]))``, ``b * m`` added to
    each index, ``[rows * peers, nb, k_mask]``."""
    global launches
    dev = seeds.device
    if dev.type != "cuda" or signs.device != dev or (
            alive is not None and alive.device != dev):
        raise ValueError("pair_mask_segments_cuda needs seeds, signs and "
                         f"alive on one CUDA device, got {seeds.device}, "
                         f"{signs.device} and "
                         f"{None if alive is None else alive.device}")
    if seeds.dim() != 2 or signs.shape != seeds.shape:
        raise ValueError(f"need seeds[rows, peers] and signs of that shape, "
                         f"got {tuple(seeds.shape)} and {tuple(signs.shape)}")
    rows, peers = seeds.shape
    if mirror and rows != peers:
        raise ValueError(f"mirror needs a square matrix, got {rows}x{peers}")
    if alive is not None and alive.shape != (rows,):
        raise ValueError(f"alive must be [{rows}], got {tuple(alive.shape)}")
    for nb, k_mask, m, leaf_id in leaves:
        if not 1 <= m < 2 ** 32:
            raise ValueError(f"m must be in [1, 2**32), got {m}")
        if rows * peers * nb * k_mask >= 2 ** 31:
            raise ValueError("a segment needs fewer than 2**31 slots")
        if leaf_id is not None and not 0 <= int(leaf_id) < 2 ** 32:
            raise ValueError(f"leaf_id must be a uint32, got {leaf_id}")
    s32 = ref.i32_bits(seeds)
    sg = signs.to(torch.float32).contiguous()
    al = None if alive is None else alive.to(torch.float32).contiguous()
    recovery = alive is not None
    flags = ((MIRROR if mirror else 0)
             | (GATE | GLOBAL | PAIR_MAJOR if recovery else 0))
    n_slots = [rows * peers * nb * k for nb, k, _, _ in leaves]
    ibuf, vbuf, offsets = _outputs(n_slots, dev)
    out = []
    for (nb, k, _, _), o, n in zip(leaves, offsets, n_slots):
        shape = ((rows * peers, nb, k) if recovery
                 else (rows, nb, peers * k))
        out.append((ibuf[o:o + n].view(shape), vbuf[o:o + n].view(shape)))
    fn = build.kernel("pair_mask_streams")
    with build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, len(leaves), MAX_SEGMENTS):
            desc = _segment_table(leaves[lo:lo + MAX_SEGMENTS],
                                  offsets[lo:lo + MAX_SEGMENTS],
                                  n_slots[lo:lo + MAX_SEGMENTS], ibuf, vbuf)
            if not desc:
                continue
            build.check(fn(s32.data_ptr(), sg.data_ptr(),
                           None if al is None else al.data_ptr(), peers,
                           rows, peers, flags, float(p), float(q),
                           (ctypes.c_longlong * len(desc))(*desc),
                           len(desc) // 6, stream), "pair_mask_streams")
            launches += 1
    return out


def _segment_table(leaves, offsets, n_slots, ibuf, vbuf) -> list:
    """The launch's segment table: six entries per leaf with work (its two
    output pointers, nb, k_mask, m, leaf id or -1)."""
    desc = []
    for (nb, k, m, leaf_id), o, n in zip(leaves, offsets, n_slots):
        if n:
            desc += [ibuf.data_ptr() + 4 * o, vbuf.data_ptr() + 4 * o,
                     nb, k, m, -1 if leaf_id is None else int(leaf_id)]
    return desc


def pair_mask_streams_cuda(seeds: torch.Tensor, signs: torch.Tensor, *,
                           nb: int, k_mask: int, m: int, p: float = -1.0,
                           q: float = 2.0):
    """The flat per-pair call, one segment of the pair-mask kernel:
    ``seeds`` (uint32 values in any integer dtype) and f32 ``signs``, one
    per pair, on one CUDA device -> ``(idx int32[N, nb, k_mask], vals
    f32[N, nb, k_mask])``."""
    if seeds.device.type != "cuda" or signs.device != seeds.device:
        raise ValueError("pair_mask_streams_cuda needs seeds and signs on one "
                         f"CUDA device, got {seeds.device} and {signs.device}")
    if seeds.dim() != 1 or signs.shape != seeds.shape:
        raise ValueError(f"need seeds[N] and signs[N], got "
                         f"{tuple(seeds.shape)} and {tuple(signs.shape)}")
    n = seeds.shape[0]
    if n == 0:
        return (torch.empty((0, nb, k_mask), dtype=torch.int32,
                            device=seeds.device),
                torch.empty((0, nb, k_mask), dtype=torch.float32,
                            device=seeds.device))
    return pair_mask_segments_cuda(seeds[:, None], signs[:, None],
                                   [(nb, k_mask, m, None)], p=p, q=q)[0]


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
    with build.on_device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(gc.data_ptr(), g.numel(), int(seed), float(p), float(q),
                float(sigma), float(sign), build.DTYPE_CODES[g.dtype],
                out.data_ptr(), mask.data_ptr(), stream)
    build.check(rc, "mask_prng_apply")
    apply_launches += 1
    return out, mask
