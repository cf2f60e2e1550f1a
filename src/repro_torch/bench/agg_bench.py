"""Aggregation-engine microbenchmarks (suite key ``agg`` ->
BENCH_torch_agg.json; port of ``repro.bench.agg_bench``).

One secure-aggregation round for a single leaf at ``n_clients`` simulated
clients —

  * ``loop``    — the seed implementation shape: a Python loop that draws
    one client's pair masks one pair at a time (``masks.client_masks``: one
    flat pair-mask launch a pair on the card), encodes that client alone
    (``secure_agg.encode_leaf``) and scatter-adds its stream alone. On the
    card it is host-bound by construction: it is the yardstick, not a path
    to tune;
  * ``batched`` — the stream engine (``core/streams.py``): every client
    encoded in one batched pass, one scatter launch for the whole round;

plus kernel-level micro timings for the two data-plane primitives — the
counter-based pair-mask PRNG (``kernels.ops.pair_mask_streams``) and the
scatter-add decode (``streams._scatter_flat``) — and the encode/decode of
every wire codec (the bit-pack kernels for the quantized ones).

The data is drawn from seeded ``torch.Generator``s on the CPU and moved to
the suite's device; every timed callable ends with ``timing.sync``.
"""
from __future__ import annotations

import torch

from repro_torch.bench.timing import entry, measure, sync
from repro_torch.core import streams
from repro_torch.core.masks import client_masks
from repro_torch.core.secure_agg import encode_leaf
from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.kernels import ops

# the --quick leaf and cohort
QUICK_SIZE, QUICK_CLIENTS = 1 << 14, 8


def _loop_round(grads, residuals, k, thgs, sa, participants, size, device):
    """The seed path: per-client encode loop + per-client scatter."""
    C = len(participants)
    k_mask = sa.k_mask_for(size, C)
    streams_all = []
    for ci, c in enumerate(participants):
        mask = client_masks(sa, c, participants, 0, 0, size, k_mask,
                            device=device)
        enc = encode_leaf(grads[ci], residuals[ci], k, thgs, mask)
        streams_all.append(enc.stream)
    dense = torch.zeros((size,), dtype=torch.float32, device=device)
    for s in streams_all:
        dense = dense + ops.stream_scatter_add(s.indices, s.values / C,
                                               size=size)
    sync(device)
    return dense


def _normal(shape, seed: int, device) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)
                       ).to(device)


def round_inputs(size: int, n_clients: int, device) -> dict:
    """One round's inputs for one leaf, as :func:`_one_size` times them:
    ``grads``, ``residuals``, ``k``, ``thgs``, ``sa``, ``participants``,
    ``k_mask`` and the cohort's ``pair_seeds`` / ``pair_signs``."""
    sa = SecureAggConfig(mask_ratio=0.01, seed=7)
    participants = list(range(n_clients))
    grads = _normal((n_clients, size), 0, device)
    # the production data plane: counter-based pair seeds (secagg/), the
    # whole cohort's masks drawn in the encode
    pair_seeds, pair_signs = streams.pair_seed_matrix(sa, participants, 0)
    return dict(grads=grads, residuals=torch.zeros_like(grads),
                k=max(1, size // 100),
                thgs=THGSConfig(s0=0.01, alpha=1.0, s_min=0.01,
                                time_varying=False),
                sa=sa, participants=participants,
                k_mask=sa.k_mask_for(size, n_clients),
                pair_seeds=pair_seeds.to(device),
                pair_signs=pair_signs.to(device))


def _one_size(size: int, n_clients: int, reps: int, device) -> list[dict]:
    x = round_inputs(size, n_clients, device)
    grads, residuals, k, thgs, sa, participants, k_mask = (
        x["grads"], x["residuals"], x["k"], x["thgs"], x["sa"],
        x["participants"], x["k_mask"])
    pair_seeds, pair_signs = x["pair_seeds"], x["pair_signs"]

    def batched_round():
        st, _ = streams.encode_leaf_batch(
            grads, residuals, k=k, nb=1, m=size, size=size,
            pair_seeds=pair_seeds, pair_signs=pair_signs, k_mask=k_mask,
            mask_p=sa.p, mask_q=sa.q, leaf_id=0)
        out = streams.decode_leaf_batch(st, nb=1, m=size, size=size)
        sync(device)
        return out

    us_loop = measure(lambda: _loop_round(grads, residuals, k, thgs, sa,
                                          participants, size, device), reps)
    us_batched = measure(batched_round, reps)

    k_total = k + n_clients * k_mask
    stream_mb = n_clients * k_total * 8 / 1e6          # int32 idx + f32 val
    dense_mb = n_clients * size * 4 / 1e6
    tag = f"c{n_clients}_n{size}"
    return [
        entry(f"agg/loop_{tag}", us_loop,
              f"{n_clients / (us_loop / 1e6):.0f}_clients_per_s", reps=reps),
        entry(f"agg/batched_{tag}", us_batched,
              f"{n_clients / (us_batched / 1e6):.0f}_clients_per_s",
              reps=reps),
        entry(f"agg/speedup_{tag}", 0.0, f"{us_loop / us_batched:.1f}x"),
        entry(f"agg/bytes_{tag}", 0.0,
              f"sparse{stream_mb:.1f}MB_vs_dense{dense_mb:.0f}MB"),
    ]


def _kernel_micro(size: int, n_clients: int, reps: int,
                  device) -> list[dict]:
    """The two data-plane primitives, isolated."""
    sa = SecureAggConfig(mask_ratio=0.01, seed=7)
    k_mask = max(1, sa.k_mask_for(size, n_clients))
    seeds = torch.arange(1, n_clients * n_clients + 1, dtype=torch.int64,
                         device=device)
    signs = torch.ones((n_clients * n_clients,), dtype=torch.float32,
                       device=device)

    def prng():
        _, vals = ops.pair_mask_streams(
            seeds, signs, nb=1, k_mask=k_mask, m=size, p=sa.p, q=sa.q)
        sync(device)
        return vals

    n_slots = n_clients * (max(1, size // 100) + n_clients * k_mask)
    gen = torch.Generator().manual_seed(1)
    flat_idx = torch.randint(0, size, (n_slots,), generator=gen,
                             dtype=torch.int32).to(device)
    flat_val = torch.randn((n_slots,), generator=gen).to(device)

    def scatter():
        out = streams._scatter_flat(flat_idx, flat_val, size)
        sync(device)
        return out

    tag = f"c{n_clients}_n{size}"
    us_prng = measure(prng, reps)
    us_scatter = measure(scatter, reps)
    return [
        entry(f"agg/mask_prng_{tag}", us_prng,
              f"{n_clients * n_clients * k_mask}_slots", reps=reps),
        entry(f"agg/scatter_add_{tag}", us_scatter,
              f"{n_slots}_slots", reps=reps),
    ]


def _codec_micro(size: int, n_clients: int, reps: int,
                 device) -> list[dict]:
    """Encode/decode throughput per wire codec (core/codecs.py, §12).

    ``enc`` is the full leaf encode (top-k + quantize + residual absorption
    + the packed-wire round trip for non-f32: one ``bitpack_rows`` and one
    ``bitunpack_rows`` launch); ``dec`` is the round decode of the
    resulting streams. f32 is the passthrough baseline, so the enc ratios
    show what the quantize+bitpack stage itself costs.
    """
    from repro_torch.core.codecs import CODECS

    k = max(1, size // 100)
    grads = _normal((n_clients, size), 2, device)
    residuals = torch.zeros_like(grads)
    tag = f"c{n_clients}_n{size}"
    out = []
    for codec in CODECS:
        def enc(_c=codec):
            st, _ = streams.encode_leaf_batch(
                grads, residuals, k=k, nb=1, m=size, size=size, codec=_c)
            sync(device)
            return st.values

        st, _ = streams.encode_leaf_batch(
            grads, residuals, k=k, nb=1, m=size, size=size, codec=codec)

        def dec(_st=st):
            out = streams.decode_leaf_batch(_st, nb=1, m=size, size=size)
            sync(device)
            return out

        us_enc = measure(enc, reps)
        us_dec = measure(dec, reps)
        slots = n_clients * k
        out += [
            entry(f"agg/codec_enc_{codec}_{tag}", us_enc,
                  f"{slots / (us_enc / 1e6) / 1e6:.1f}_Mslots_per_s",
                  reps=reps),
            entry(f"agg/codec_dec_{codec}_{tag}", us_dec,
                  f"{slots / (us_dec / 1e6) / 1e6:.1f}_Mslots_per_s",
                  reps=reps),
        ]
    return out


def entries(quick: bool = False, device="cuda") -> list[dict]:
    # headline: the paper-model regime (financial MLP/VGG leaves, 64k
    # params); the second size shows the top-k-bound tail where both paths
    # converge on the same sort cost
    device = torch.device(device)
    if quick:
        size, C = QUICK_SIZE, QUICK_CLIENTS
        return (_one_size(size, C, 2, device)
                + _kernel_micro(size, C, 3, device)
                + _codec_micro(size, C, 2, device))
    out = _one_size(1 << 16, 32, 3, device)
    out += _one_size(1 << 20, 32, 2, device)
    out += _kernel_micro(1 << 16, 32, 5, device)
    out += _codec_micro(1 << 16, 32, 3, device)
    return out

