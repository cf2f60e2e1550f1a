"""Plain PyTorch versions of the port's CUDA kernels (port of
``repro.kernels.ref``), and the counter-based DP streams, which no kernel
computes.

These are the functions the CPU tests hold against the JAX reference and the
functions ``chip_smoke.py`` holds each CUDA kernel against on the card. The
main path never calls them for a CUDA tensor: ``kernels/ops.py`` dispatches by
the tensor's device.

uint32 arithmetic: PyTorch has no ``+``, ``>>`` or ``%`` for uint32 on the
CPU, so every murmur lane is an int64 holding a value in ``[0, 2**32)`` and
every step masks back to 32 bits. The multiply is split into 16-bit halves so
no int64 product overflows (a plain ``x * 0x846CA68B`` needs 64 bits).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
NEG_INF = -1e30

# Domain-separation salts, identical to the JAX reference: one murmur stream
# for support indices, one for values, one for per-leaf seed folding.
IDX_SALT = 0x9E3779B9
VAL_SALT = 0x85EBCA6B
LEAF_SALT = 0xA511E9B3
# Salts of the distributed-DP streams (core/dp.py): two murmur streams per
# client feed a Box-Muller transform, one public stream draws the round's
# common release support. Distinct from the three above, so DP draws never
# collide with the pair-mask draws under equal seeds.
DP_U1_SALT = 0x94D049BB
DP_U2_SALT = 0xBF58476D
DP_SUP_SALT = 0xC2B2AE35


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 lanes ``x`` in ``[0, 2**32)``."""
    lo = x * (c & 0xFFFF)                        # < 2**48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16        # low 16 bits, shifted
    return (lo + hi) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche of uint32 lanes held in int64."""
    x = x.to(torch.int64) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def as_u32(seeds: torch.Tensor) -> torch.Tensor:
    """Integer seed tensor -> int64 lanes holding its uint32 values."""
    return seeds.to(torch.int64) & M32


def fold_leaf_seed(seeds: torch.Tensor, leaf_id: int) -> torch.Tensor:
    """Fold a leaf id into pair seeds: ``mix32(seed ^ mix32(leaf + SALT))``."""
    leaf = torch.tensor((int(leaf_id) + LEAF_SALT) & M32, dtype=torch.int64,
                        device=seeds.device)
    return _mix32(as_u32(seeds) ^ _mix32(leaf))


def pair_mask_stream_ref(seeds, signs, nb: int, k_mask: int, m: int,
                         *, p: float, q: float):
    """Counter-based sparse pair-mask streams.

    For each seed, flat counter ``c = block * k_mask + slot``:
    ``idx = mix32(mix32(seed ^ IDX_SALT) + c) % m`` and
    ``val = sign * (p + q * (mix32(mix32(seed ^ VAL_SALT) + c) >> 8) / 2**24)``.
    Returns ``(idx int64->int32[..., nb, k_mask], vals f32[..., nb, k_mask])``.
    """
    seeds = as_u32(seeds)
    dev = seeds.device
    signs = torch.as_tensor(signs, dtype=torch.float32, device=dev)
    c = torch.arange(nb * k_mask, dtype=torch.int64, device=dev)
    c = c.reshape((1,) * seeds.dim() + (nb, k_mask))
    base_i = _mix32(seeds ^ IDX_SALT)[..., None, None]
    base_v = _mix32(seeds ^ VAL_SALT)[..., None, None]
    idx = (_mix32((base_i + c) & M32) % m).to(torch.int32)
    # top 24 bits: the f32-exact 2^-24 grid, so colliding masks cancel
    # bit-exactly in the scatter-add
    u = (_mix32((base_v + c) & M32) >> 8).to(torch.float32) / float(2 ** 24)
    vals = signs[..., None, None] * (p + q * u)
    return idx, vals


def pair_mask_segments_ref(seeds, signs, leaves, *, p: float = -1.0,
                           q: float = 2.0, mirror: bool = False,
                           alive=None) -> list:
    """Plain version of the segmented pair-mask kernel: for ``[rows,
    peers]`` seeds and signs and each leaf ``(nb, k_mask, m, leaf_id or
    None)``, the seed read at ``(min(i, j), max(i, j))`` under ``mirror``,
    the leaf folded in, the streams drawn with sign 1 and multiplied by
    ``signs[i, j]``. Returns one ``(idx int32, vals f32)`` per leaf,
    ``[rows, nb, peers * k_mask]``; with ``alive``, the recovery streams:
    values multiplied by ``-(alive[i] * (1 - alive[j]))``, ``b * m`` added
    to the indices, ``[rows * peers, nb, k_mask]``."""
    seeds = as_u32(seeds)
    dev = seeds.device
    rows, peers = seeds.shape
    if mirror:
        i = torch.arange(rows, device=dev)[:, None]
        j = torch.arange(peers, device=dev)[None, :]
        seeds = seeds[torch.minimum(i, j), torch.maximum(i, j)]
    signs = torch.as_tensor(signs, dtype=torch.float32, device=dev)
    ones = torch.ones((rows, peers), dtype=torch.float32, device=dev)
    gate = None
    if alive is not None:
        a = torch.as_tensor(alive, device=dev).to(torch.float32)
        gate = a[:, None] * (1.0 - a[None, :])
    out = []
    for nb, k_mask, m, leaf_id in leaves:
        s = seeds if leaf_id is None else fold_leaf_seed(seeds, leaf_id)
        idx, mag = pair_mask_stream_ref(s, ones, nb, k_mask, m, p=p, q=q)
        vals = signs[:, :, None, None] * mag
        if gate is not None:
            vals = -gate[:, :, None, None] * vals
            idx = torch.arange(nb, dtype=torch.int32,
                               device=dev)[:, None] * m + idx
            shape = (rows * peers, nb, k_mask)
            out.append((idx.reshape(shape), vals.reshape(shape)))
        else:
            shape = (rows, nb, peers * k_mask)
            out.append((idx.permute(0, 2, 1, 3).reshape(shape),
                        vals.permute(0, 2, 1, 3).reshape(shape)))
    return out


def thgs_sparsify_ref(g: torch.Tensor, residual: torch.Tensor,
                     threshold) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused THGS threshold split: ``acc = f32(g) + f32(residual)``,
    ``sparse = acc * 1[|acc| > f32(threshold)]``, ``resid = acc - sparse``,
    cast back to g's and residual's dtypes. ``threshold`` is a float or a
    one-element tensor.

    The residual follows the Pallas kernel (``acc - sparse``), not the JAX
    reference's oracle (``where(keep, 0, acc)``): the two differ only where a
    kept accumulator is +-inf, which gives NaN here as in the kernel."""
    acc = g.to(torch.float32) + residual.to(torch.float32)
    thr = torch.as_tensor(threshold, device=acc.device).to(torch.float32)
    sparse = torch.where(acc.abs() > thr.reshape(()), acc, 0.0)
    return sparse.to(g.dtype), (acc - sparse).to(residual.dtype)


def _fma_f32(a, x: torch.Tensor, b) -> torch.Tensor:
    """``fma(f32(a), x, f32(b))`` for f32 ``x``, rounded once to f32; ``a``
    and ``b`` are Python floats (taken as f32) or f32 tensors.

    In f64 the product of two f32 values is exact; the sum may round, so it
    is rounded to odd (TwoSum gives the exact error; an inexact sum whose
    last bit is even moves one f64 ulp toward the exact value), and 53 >=
    24 + 2 bits makes the final round-to-nearest-even to f32 correct."""
    f64 = torch.float64
    a = torch.as_tensor(a, dtype=torch.float32, device=x.device).to(f64)
    b = torch.as_tensor(b, dtype=torch.float32, device=x.device).to(f64)
    prod = x.to(f64) * a
    s = prod + b
    bb = s - prod
    err = (prod - (s - bb)) + (b - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(f64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def mask_prng_ref(g: torch.Tensor, seed: int, *, p: float, q: float,
                  sigma: float,
                  sign: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Counter-based sparse mask generation and add (Eq. 3-5):
    ``u(i) = p + q * f32(mix32(i ^ seed)) / 2**32`` for the flat position
    ``i``, ``mask = where(u < sigma, u, 0) * sign``; returns ``(g + mask``
    in g's dtype, ``mask`` f32), both of g's shape.

    Rounds ``p + q * u`` once, as the JAX reference's jitted entry does in
    the vectorized loop XLA compiles it to (one fused multiply-add),
    emulated exactly by :func:`_fma_f32`. The reference's eager oracle, and
    XLA's scalar loops (small arrays, some loop remainders), round the
    product first; all agree at the default ``p = -1, q = 2``, where the
    product is exact. The uint32 -> f32 conversion of the
    int64 lane rounds to nearest even, as XLA's; ``sign = -1`` leaves -0.0
    off the support."""
    f32 = torch.float32
    i = torch.arange(g.numel(), dtype=torch.int64, device=g.device)
    x = _mix32(i ^ (int(seed) & M32))
    u = _fma_f32(q, x.to(f32) * 2.0 ** -32, p)
    keep = u < torch.tensor(sigma, dtype=f32, device=g.device)
    mask = torch.where(keep, u, 0.0) * torch.tensor(sign, dtype=f32,
                                                     device=g.device)
    mask = mask.reshape(g.shape)
    return (g.to(f32) + mask).to(g.dtype), mask


def stream_scatter_add_ref(indices: torch.Tensor, values: torch.Tensor,
                           size: int) -> torch.Tensor:
    """Scatter-add a flat stream into dense f32[size]; out-of-range dropped.

    Every position folds its contributions in slot order starting from +0.0,
    as the JAX reference's scatter does on the CPU. PyTorch's accumulating
    scatters promise no order (``index_put_(accumulate=True)`` uses atomic
    adds across threads on a large CPU input, and sorts plus warp-reduces on
    CUDA), so the fold is built from its definition. On the CPU it is
    numpy's unbuffered ``np.add.at``, which applies the slots one by one in
    order in f32; on another device, :func:`scatter_fold_by_rank`. Both cost
    little for any multiplicity on the CPU path, where the tree decode's
    dump slot takes most of a stream."""
    idx = indices.reshape(-1).to(torch.int64)
    val = values.reshape(-1).to(torch.float32)
    valid = (idx >= 0) & (idx < size)
    idx, val = idx[valid], val[valid]
    if val.device.type != "cpu":
        return scatter_fold_by_rank(idx, val, size)
    out = np.zeros(size, np.float32)
    np.add.at(out, idx.numpy(), val.numpy())
    return torch.from_numpy(out)


def scatter_fold_by_rank(idx: torch.Tensor, val: torch.Tensor, size: int,
                         dtype=torch.float32) -> torch.Tensor:
    """The slot-order fold on any device, for in-range int64 ``idx``: each
    slot's rank among the earlier slots of its index (a stable sort), then
    one pass per rank, each a plain add at distinct positions, rounded to
    ``dtype``. Its passes grow with the largest multiplicity of an index."""
    out = torch.zeros(size, dtype=dtype, device=val.device)
    val = val.to(dtype)
    n = idx.numel()
    if n == 0:
        return out
    order = torch.argsort(idx, stable=True)
    s = idx[order]
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = s[1:] != s[:-1]
    seg_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - seg_start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        at = idx[sel]
        out[at] = out[at] + val[sel]
    return out


# ------------------------------------------------------------ DP streams
def _counter_stream(seeds: torch.Tensor, salt: int, nb: int,
                    k: int) -> torch.Tensor:
    """``mix32(mix32(seed ^ salt) + c)`` for flat counter ``c = block * k +
    slot``: int64 lanes holding uint32 values, shape ``[..., nb, k]``."""
    seeds = as_u32(seeds)
    c = torch.arange(nb * k, dtype=torch.int64, device=seeds.device)
    c = c.reshape((1,) * seeds.dim() + (nb, k))
    base = _mix32(seeds ^ salt)[..., None, None]
    return _mix32((base + c) & M32)


def dp_support_stream_ref(seeds: torch.Tensor, nb: int, k: int,
                          m: int) -> torch.Tensor:
    """The PUBLIC common release support of a DP round:
    ``mix32(mix32(seed ^ DP_SUP_SALT) + c) % m`` -> int32[..., nb, k].
    Mod-``m`` collisions may repeat an index in a block; the stream's
    first-occurrence gate sends the gradient there once."""
    return (_counter_stream(seeds, DP_SUP_SALT, nb, k) % m).to(torch.int32)


def dp_noise_stream_ref(seeds: torch.Tensor, nb: int, k: int, *,
                        sigma: float) -> torch.Tensor:
    """Grid-rounded Gaussian noise ``round(z * sigma * 2^24) * 2^-24``,
    ``z`` by Box-Muller from two 24-bit counter streams (``u1`` in (0, 1],
    ``u2`` in [0, 1)) -> f32[..., nb, k] on the mask grid, so masks and
    noise add exactly. ``z`` uses PyTorch's f32 ``log``/``cos``, which may
    differ from XLA's in the last bit: the rounded value then moves by a
    grid step (tests/test_torch_dp.py states the tolerance)."""
    f32 = torch.float32
    dev = seeds.device
    u1 = ((_counter_stream(seeds, DP_U1_SALT, nb, k) >> 8).to(f32) + 1.0) \
        / torch.tensor(2.0 ** 24, dtype=f32, device=dev)
    u2 = (_counter_stream(seeds, DP_U2_SALT, nb, k) >> 8).to(f32) \
        / torch.tensor(2.0 ** 24, dtype=f32, device=dev)
    two_pi = torch.tensor(2.0 * 3.141592653589793, dtype=f32, device=dev)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
    q = torch.round(z * torch.tensor(sigma, dtype=f32, device=dev)
                    * torch.tensor(2.0 ** 24, dtype=f32, device=dev))
    return q * 2.0 ** -24


# ------------------------------------------------------ wire bit packing
# A row of ``k`` fields of ``w`` bits is one contiguous bit stream, least
# significant bit first: field ``s`` holds bits ``[s*w, s*w + w)`` of the
# row's uint32 word array. The reference packs in chunks of PACK_CHUNK = 32
# slots (a chunk fills exactly ``w`` words: its TPU tiling), which lays the
# bits out the same way.
PACK_CHUNK = 32


def packed_words(count: int, width: int) -> int:
    """uint32 words needed for ``count`` fields of ``width`` bits."""
    return -(-count * width // 32)


def bitpack_rows_ref(u: torch.Tensor, width: int) -> torch.Tensor:
    """Pack ``[R, k]`` fields (uint32 values in any integer dtype; the low
    ``width`` bits of each are taken) into ``[R, ceil(k*width/32)]`` words.
    Returns int64 lanes holding the uint32 words; padding bits are zero.
    Built bit by bit: every field is spread into its ``width`` bits, the
    bit stream is cut into 32-bit words and each word is summed back."""
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in 1..32, got {width}")
    R, k = u.shape
    W = packed_words(k, width)
    b = torch.arange(width, dtype=torch.int64, device=u.device)
    bits = (as_u32(u)[..., None] >> b) & 1                 # [R, k, width]
    bits = bits.reshape(R, k * width)
    bits = torch.nn.functional.pad(bits, (0, 32 * W - k * width))
    j = torch.arange(32, dtype=torch.int64, device=u.device)
    return (bits.reshape(R, W, 32) << j).sum(-1)


def bitunpack_rows_ref(words: torch.Tensor, k: int,
                       width: int) -> torch.Tensor:
    """Inverse of :func:`bitpack_rows_ref`: ``[R, W]`` words (uint32
    values in any integer dtype) -> ``[R, k]`` fields, int64 lanes holding
    values below ``2**width``."""
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in 1..32, got {width}")
    R, W = words.shape
    if 32 * W < k * width:
        raise ValueError(f"{W} words hold fewer than {k} fields of "
                         f"{width} bits")
    j = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((as_u32(words)[..., None] >> j) & 1).reshape(R, 32 * W)
    bits = bits[:, :k * width].reshape(R, k, width)
    b = torch.arange(width, dtype=torch.int64, device=words.device)
    return (bits << b).sum(-1)


# one pack or unpack launch takes at most this many segments
MAX_SEGMENTS = 8


def check_segments(arrays, widths, name: str) -> None:
    """Refuse a segment list the segmented launches do not take."""
    if not 1 <= len(arrays) <= MAX_SEGMENTS or len(widths) != len(arrays):
        raise ValueError(f"{name} takes 1..{MAX_SEGMENTS} arrays and one "
                         f"width each, got {len(arrays)} and {len(widths)}")
    for x in arrays:
        if x.dim() != 2:
            raise ValueError(f"{name} needs [rows, n] arrays, got shape "
                             f"{tuple(x.shape)}")


def i32_lanes(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding uint32 values -> int32 lanes with the same bits."""
    return (x & M32).to(torch.int32)


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in any integer dtype -> the same bits as contiguous
    int32 lanes (int32 lanes are taken as they are)."""
    if x.dtype != torch.int32:
        x = i32_lanes(x.to(torch.int64))
    return x.contiguous()


def bitpack_segments_ref(fields, widths) -> list:
    """Plain version of the segmented pack: each ``[R_i, k_i]`` field array
    through :func:`bitpack_rows_ref` at its width; words as int32 lanes
    holding the uint32 bits."""
    check_segments(fields, widths, "bitpack_segments")
    return [i32_lanes(bitpack_rows_ref(u, w)) for u, w in zip(fields, widths)]


def bitunpack_segments_ref(words, ks, widths) -> list:
    """Plain version of the segmented unpack: each ``[R_i, W_i]`` word array
    through :func:`bitunpack_rows_ref` to ``k_i`` fields at its width; fields
    as int32 lanes holding the uint32 bits."""
    check_segments(words, widths, "bitunpack_segments")
    if len(ks) != len(words):
        raise ValueError(f"bitunpack_segments needs one k per array, got "
                         f"{len(ks)} for {len(words)}")
    return [i32_lanes(bitunpack_rows_ref(x, k, w))
            for x, k, w in zip(words, ks, widths)]


# ------------------------------------------------------------ attention
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """``[B,T,H,hd] x [B,S,Hkv,hd]`` GQA attention in f32 (twin of
    ``repro.kernels.ref.flash_attention_ref``): K/V repeated per group, f32
    scores, masked scores set to -1e30 (a row with every key masked gets the
    uniform average), softmax, the output cast to q's dtype. Positions count
    from 0 for both q and k."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    group = h // k.shape[2]
    kf = torch.repeat_interleave(k, group, dim=2).float()
    vf = torch.repeat_interleave(v, group, dim=2).float()
    scores = torch.einsum("bthd,bshd->bhts", q.float(), kf) / (hd ** 0.5)
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, vf)
    return out.to(q.dtype)
