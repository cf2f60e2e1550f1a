#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line or more each; any failure
exits non-zero and no failure is caught:

  1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions; the
     CUDA kernels are built from ``src/repro_torch/kernels/csrc`` (build time
     printed).
  2. kernels: each CUDA kernel against its plain PyTorch version on the card,
     bit-equal, at the shapes of the main path (mnist_mlp leaf ``l0.w``) and
     at VGG16's 512x512x3x3 leaf, with duplicates, -1 padding, out-of-range
     entries and the order-sensitive triple [1, 2^-24, -1]; the scatter
     also at one tree group's ``width + 1`` buffer of tree_quick's ``l0.w``
     (two thirds of the slots at the dump slot, +0.0) and on
     correctness-only inputs (one tile, a position with 12,000 non-zero
     entries, all zeros, +-inf and NaN, n = 0, size = 1, odd sizes, n below
     a chunk, more than 8192 tiles), its two passes timed as one call in a
     CUDA graph with the scratch allocated outside it; the bit-pack
     kernels at every width 1..32, at the codec path's shapes one segment
     at a time (5 rows, k = 7,880 at 18 and 8 bits; VGG16's k = 60,199 at
     22 and 1 bit) and as the two-segment leaf launches the codec path
     makes (18 + 8 bits, 22 + 1 bit; one launch a call); median times from
     CUDA events beside the bound and the library call; the pair-mask
     kernel's round launch at mnist_mlp's 4 leaves and VGG16's 54 (5
     clients, the protocol's matrices, one client dropped): every leaf's
     masks, then every leaf's recovery streams, one launch each, bit-equal
     to the segmented plain version and to the per-leaf flat launches,
     the raw launch timed in a CUDA graph beside the round function, the
     plain version and the bound; the flat per-pair call (one segment) at
     mnist_mlp's ``l0.w`` and VGG16's 512x512x3x3 (15 pairs); the CUDA
     kernels and host-to-device copies of one round's mask path
     (``torch.profiler``); ``thgs_sparsify`` and ``mask_prng_apply``
     bit-equal (as bits) at VGG16's largest leaf (f32 and bf16), mnist_mlp's
     l0.w and odd sizes,
     with ties at f32(0.1), +-inf accumulators, both signs, three (p, q)
     and the uint32 -> f32 rounding probes, then driven through ``ops`` over
     every leaf of mnist_mlp and VGG16 (counts reset before, read after)
     and timed cold (raw launches in a CUDA graph over buffer sets larger
     than L2) beside the bound, the wrapper and the plain version.
  3. main path: ``table2_quick`` (mnist_mlp 784-200-10 at full width, 12
     rounds of THGS + sparse-mask secure aggregation) through
     ``repro_torch.sim.Simulation`` on the card, after a one-round warm-up;
     launch counts reset just before and read just after (the pair-mask
     kernel once a round: 12); the paper-accounting upload ratio and the
     accuracy checked against the reference's numbers; round 0's ``l0.w``
     encode and decode replayed on the CPU with the plain versions, bit-equal.
  4. recovery: ``secagg_quick`` (dropout 0.25) on the card, the pair-mask
     kernel launched once a round and twice a dropout round (masks, then
     recovery streams, of every leaf); a dropped round's decoded aggregate
     held against the survivors' unmasked weighted sparse sum computed with
     the plain versions.
  5. full-size model: cifar_vgg16 on cifar10 under the table2 protocol,
     2 rounds (the 54 leaves' masks in one launch a round: 2).
  6. codecs: ``codec_sweep_quick`` (the table2 protocol without secagg, one
     arm per wire codec f32/int8/int4/1bit, 12 rounds each) on the card;
     counts reset before the sweep and read after it (48 launches of each
     bit-pack kernel per quantized arm, one a leaf for both of its wire
     streams: 144 a sweep); each arm's upload under both
     accountings against the f32 arm, its accuracy and launches; round 0's
     ``l0.w`` replayed on the CPU with the plain versions: bit-equal for
     int8/int4, within the 1bit scale tolerance (4 ulp) for 1bit; the
     CUDA kernels of one ``codec_wire_roundtrip`` call (``torch.profiler``)
     and its time.
  7. DP: ``dp_quick`` (secagg, dropout 0.25, clip 1, z 0.6) and the four
     arms of ``dp_frontier_quick`` on the card: the composed epsilon of each
     arm against the reference's (40.1; 89.7 / 33.7 / 14.1), a dropout
     round's decoded sum against the survivors' unmasked noised sum
     (64 * 2^-24), and the off arm bit-identical to the same run with an
     inactive ``DPConfig()``.
  8. tree: ``tree_quick`` (secagg, dropout 0.25, 3 sub-aggregators) on the
     card: every leaf's tree decode bit-equal to the flat decode of the same
     streams, survivors [5, 6, 4, 4, 4, 5, 5, 5], upload 6.3% +- 0.5 pt,
     accuracy against the port's CPU run and the reference's 0.941, 96
     scatter launches, 8 + 7 pair-mask launches (one a round, one more a
     dropout round; ``dp_quick`` likewise); then 2 VGG16 rounds under the
     tree protocol (G = 3), each leaf bit-equal to flat, the
     2,359,296-element leaves also over an uneven split.
  9. async: ``async_quick`` (FedBuff buffer 4, max staleness 3) on the card:
     the reference's staleness vectors, upload 7.0% +- 0.5 pt, accuracy;
     then an all-fresh buffer through ``run_async_update`` bit-equal to
     ``run_round``.
 10. flash: the HGMMA instructions in the built flash library's SASS
     (``cuobjdump -sass``: the bf16 instances run on the tensor cores); the
     flash-attention kernel against its plain version on the card (2e-5 in
     f32, 2e-2 in bf16; max abs error and error relative to max |plain|) at
     Yi-6B's prefill shape (B 4, T = S = 1024, 32 heads, 4 kv heads, hd 128,
     bf16, causal), a 4096-token prompt, f32, ragged tails (24, 1000), MQA, a
     256-token window, and in bf16 hd 64, causal=False, T > S with rows that
     have no key, T and S not multiples of 128, T != S, a window at hd 64,
     and three needle cases (V = 1000 at a future key, at a key just outside
     the window, and in the memory past S), where the rows that must not see
     the needle are checked on their own; head widths 80 and 112 (P V padded
     to 128 on the tensor cores) at HuBERT-XLarge's encode (B 4, T = S =
     1024, 16 heads, non-causal) and Zamba2-7B's shared block (B 4, T = S =
     1024, 32 heads, causal), in f32, with ragged tails and needles at each
     width; for Yi-6B's two rows and the two hd-80/112 model rows, the raw
     launch time beside the bound (the flops of the pairs the mask keeps),
     the plain version and ``scaled_dot_product_attention`` as the library
     yardstick, and for the f32 rows the raw launch time beside its bound at
     the f32 CUDA-core rate.
 11. lm: Yi-6B at full width (32 layers, d_model 4096, bf16, 12.1 GB of
     random weights drawn on the card from seed 0) served by
     ``InferenceServer(LMAdapter(max_batch=4, prompt_len=1024, n_new=16))``
     under ``LoadGenerator``: 8 requests, 0 errors, 16 tokens each in the
     vocabulary, 32 flash launches per prefill (counts reset before and read
     after), a valid ``repro.serve/v1`` document; prefill and decode times,
     tokens/s, peak memory; then Yi-6B at full width and 2 layers in f32
     (TF32 off), one 256-token prompt and 4 new tokens, on the card against
     the CPU's plain path: logits within 2e-4 and equal tokens.
 12. resume: ``table2_quick`` killed by a round hook after round 6 and
     resumed to 12 (a checkpoint every 6 rounds under ``build/smoke``), then
     ``async_quick`` killed after round 4 of 8: ledger entries, accuracies,
     losses, final params, residuals (and the async version ring) bit-equal
     to an uninterrupted run in this process; counts reset before the
     killed leg and read after the resumed one (the pair-mask kernel 12
     times over the two legs of table2_quick); each killed checkpoint is
     also resumed by ``python -m repro_torch.sim --ckpt-dir`` in a fresh
     process, whose ledger, accuracies, losses and final checkpoint must be
     bit-equal to the same uninterrupted run; then VGG16 under the table2
     protocol, 2 rounds: two serial engine runs, each started with cuDNN
     left non-deterministic and autotuning (the engine must set
     deterministic cuDNN itself), bit-equal to each other, and the run
     killed after round 1 and resumed, bit-equal to them (2 mask launches
     over both legs); VGG16's local SGD timed with and without
     deterministic cuDNN, in turns; then one VGG16 checkpoint (its params
     and 10 clients' residuals, about 650 MB on disk): save and restore
     times, restored bit-equal.
 13. serve: ``python -m repro_torch.serving --preset table2 --qps 1000``
     through its ``main()`` on the card (training in the main thread, the
     server, the load generator and the checkpoint watcher in threads;
     counts reset before and read after): 0 errors, at least one swap, the
     final published step active, a valid ``repro.serve/v1`` document, at
     least 200 requests served before training ended; served count,
     latency p50/p99, swap pauses and staleness printed; then
     one VGG16 publish (14,728,266 parameters) staged through the
     ``CheckpointWatcher`` while 120 large matmuls sit queued on the
     default stream: host load ms, side-stream copy ms, swap pause, the
     queued work still running when the staging ended (it waits on its own
     stream's event only), logits after the swap bit-equal to a cold
     restore.
 14. sharded: the client-sharded round on shards that share the card
     (``ClientsMesh((cuda:0,) * n)``; counts reset before each run, read a
     round at a time by a round hook). The pair-mask kernel's row launch (a
     shard's rows of the seed matrix, ``rows = C_loc < peers = C``, no
     mirror) at mnist_mlp's 4 leaves (C 6, shards of 2 and 3) and VGG16's
     54 (C 5, one client a shard), bit-equal to its plain version and to
     the mirrored round launch's rows, timed beside them. The reference's
     parity configuration (mnist_mlp at full width, 12 clients, cohort 6,
     3 rounds, dropout 0.4, weights by data count, mask ratio 0.02, seed 1)
     over 2, 3 and 6 shards against the serial run: params, every client's
     residuals, ledger entries and accuracies bit-equal, at least one
     dropout round, each round's pair-mask launches = shards (+1 in a
     dropout round) and scatter launches = leaves; ``tree_quick`` over 3
     shards, ``dp_quick`` over 2 and ``codec_sweep_quick``'s int8 arm over
     5 (20 pack and 4 unpack launches a round) likewise, every leaf's
     sharded encode/decode fed the serial run's deltas bit-equal to the
     serial one. The one-client shard's local SGD with and without its
     duplicated row, at the int8 arm's and VGG16's first round: bit-equal
     to the cohort's batch or not, and timed. VGG16 under the table2
     protocol, 2 rounds over 5 shards, under deterministic cuDNN: two
     serial runs bit-equal; the per-leaf sharded encode/decode fed the
     serial deltas bit-equal; the sharded run bit-equal to a serial run
     whose local SGD runs at the shards' batch shape; against the plain
     serial run, the first round and leaf that differ, and the params
     within ``VGG_PARAM_ATOL``. Round wall times, serial against sharded,
     and the bytes the stream gather and the residual return copy a round
     are printed.
 15. bench: ``python -m repro_torch.bench --quick --out`` through its
     ``main()`` on the card (the ``round``, ``agg``, ``cohort`` and ``serve``
     suites; counts reset before, read after): the document valid, its env
     naming the card and the power limit ``nvidia-smi`` gives, every
     suite's entry names equal to the reference's quick names, each of the
     scatter, pair-mask, both bit-pack and the flash kernels launched; the
     run gated against the committed ``BENCH_torch_*.json`` (exit 0, at
     least one entry compared); then, at the suites' ``--quick`` shapes and
     on their inputs (launches not counted): ``pair_mask`` for every
     ordered pair of the agg cohort, ``client_masks`` and ``encode_leaf``
     for each of its clients bit-equal to the same calls on the CPU; the
     agg micro's 64-pair flat mask launch, the cohort streams' flat and
     tree decodes (C = 64, 256, 1,024) and the codec packs and unpacks at
     8 x 163 fields (int8, int4, 1bit widths) bit-equal to their plain
     versions on the same card tensors; the loop round's dense sum
     bit-equal to the CPU's and within ``LOOP_BATCHED_ATOL`` of the
     batched round's; the flash kernel's f32 instance at the reduced
     Yi-6B prefill (B 4, T 16, 4 heads, 2 kv, hd 64) within 2e-5 of its
     plain version; then ``--csv --only table1,table2,fig1,fig3 --quick``
     (the paper-table drivers on the card) and its rows printed.
 16. families (run after 11): every other LM family at full width, one
     config at a time and freed before the next, bf16 weights drawn on the
     card from seed 0: DeepSeek-MoE-16B (8 of 28 layers) and
     Llama-4-Scout-17B-16E (2 of 48, top-1) at B 4, Llama-3.2-Vision-90B (10
     of 100 layers: 2 super-blocks, 1,024 seeded image embeddings) at B 2,
     Zamba2-7B (all 81) and xLSTM-125M (all 12) at B 4, each a 1,024-token
     prompt and 16 greedy tokens; HuBERT-XLarge (all 48) encodes 4 x 1,024
     seeded frames. Counts reset before the first prefill and read after it:
     flash launched once per attention layer (cross-attention included; the
     hybrid's shared block once a super-block), and the first flash call of
     each shape in that prefill within 2e-2 of the plain version on its own
     inputs; two more prefills bit-equal to it; finite logits and tokens in
     the vocabulary; the reference's contract (forward over T + 1 against
     prefill(T) + one decode step) within ``FAMILY_TOL`` in bf16, MoE held
     where the reference's test holds it (no token dropped, f32), its bf16
     gap at the configured capacity printed; the last MoE layer of that
     prefill, at the configured capacity in f32, on the card against the
     same inputs on the CPU (equal experts and slots, some token dropped, y
     within ``MOE_CAP_ATOL``); the encoder's decode step raises. Prefill and
     decode times, peak memory, one profiled prefill and decode step.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--only flash`` runs phases 1 and 10
alone, does not require HGMMA instructions, and prints no result line (the
kernel's times on one tree, to compare two trees in one call); ``--only
pack`` runs phase 1, the bit-pack part of phase 2 and the round-trip probe
of phase 6 the same way (on a tree without segmented launches, the parent
of that design, a leaf pair is timed as its two single launches); ``--only
masks`` runs phase 1, the pair-mask kernel's round and flat rows of phase 2
and the mask path probe the same way (on the parent of the round launch, a
round is timed as its per-leaf flat launches); ``--only sharded`` runs
phases 1 and 14, ``--only bench`` phases 1 and 15, ``--only families``
phases 1 and 16. Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
MASK_OPS_PER_SLOT = 25         # integer ops of one pair-mask slot (two mix32
                               # chains, mod, shift, convert, 2 mul + add),
                               # counted at the f32 rate: the data sheet
                               # gives no int32 rate
PACK_OPS_PER_FIELD = 4         # mask, shift, OR, offset of one packed field
                               # (both directions), at the f32 rate
ONE_BIT_REL = 4 * 2.0 ** -23   # the 1bit scale: a mean summed in another
                               # order on the card than on the CPU


def bound(bytes_: int, ops: int,
          rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def events_ms(fn, *, reps: int = 5, inner: int = 20,
              warmup: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, in ms (after ``warmup`` calls). Host time between
    launches is counted when the host is the slower side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(launch, *, reps: int = 7, inner: int = 50) -> float:
    """Device time per call of ``launch``, in ms: ``inner`` calls captured in
    one CUDA graph, the replay timed with CUDA events (median of ``reps``),
    so no host time is counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2
def scatter_inputs(n: int, size: int, seed: int, *, adversarial: bool):
    """A main-path-like stream of ``n`` slots into ``size`` positions:
    random indices (duplicates occur), values on the mask grid plus small
    gradients. ``adversarial`` adds -1 padding, indices >= size, exact
    cancellations (-0.0 partials) and the order-sensitive triple."""
    import numpy as np

    rs = np.random.RandomState(seed)
    idx = rs.randint(0, size, size=n).astype(np.int32)
    vals = (rs.randint(-2**23, 2**23, size=n) / 2.0**23
            + rs.randn(n) * 1e-3).astype(np.float32)
    hot = idx[: max(1, n // 100)]
    idx[n // 2: n // 2 + len(hot)] = hot          # forced duplicates
    if adversarial:
        pos = np.arange(0, n, 97)
        idx[pos[: len(pos) // 2]] = -1            # wrapper-style padding
        idx[pos[len(pos) // 2:]] = size + (pos[len(pos) // 2:] % 7)
        p0 = int(idx[1])
        idx[idx == p0] = (p0 + 1) % size
        for slot, v in zip((n // 5, n // 2 + 1, n - 3),
                           (1.0, 2.0 ** -24, -1.0)):
            idx[slot], vals[slot] = p0, v         # [1, 2^-24, -1] in order
        idx[3], vals[3] = (p0 + 2) % size, -0.0   # a lone -0.0
        q0 = int(idx[5])
        idx[7], vals[7] = q0, -vals[5]            # exact cancellation
        return idx, vals, p0
    return idx, vals, None


def scatter_row(tag: str, it, vt, size: int, device, *,
                plain_reps: int = 3) -> dict:
    """The scatter's raw launch (both passes of one call in a CUDA graph,
    scratch allocated outside it), its wrapper, its plain version and
    ``zero_().index_add_`` timed on one stream; the bound counts the stream
    read once and the output written once."""
    import torch

    from repro_torch.kernels import build, ref, stream_decode

    n = it.numel()
    scatter = build.kernel("stream_scatter_add")
    out = torch.empty(size, device=device)
    work = stream_decode.workspace(n, size, device)

    def launch_scatter():
        build.check(scatter(it.data_ptr(), vt.data_ptr(), n, out.data_ptr(),
                            size, work.data_ptr(), work.numel(),
                            torch.cuda.current_stream().cuda_stream),
                    "stream_scatter_add")

    ms = graph_ms(launch_scatter)
    wrapper_ms = events_ms(lambda: stream_decode.stream_scatter_add_cuda(
        it, vt, size))
    plain_ms = events_ms(lambda: ref.stream_scatter_add_ref(it, vt, size),
                         reps=plain_reps, inner=plain_reps,
                         warmup=min(3, plain_reps))
    i64 = it.to(torch.int64)
    lib_out = torch.empty(size, device=device)
    lib_ms = graph_ms(lambda: lib_out.zero_().index_add_(0, i64, vt))
    bound_ms, bound_by = bound(8 * n + 4 * size, n)
    print(f"[kernels] stream_scatter_add {tag}: n={n} size={size} "
          f"ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
          f"plain_ms={plain_ms:.6f} zero+index_add_ms={lib_ms:.6f} "
          f"bound_ms={bound_ms:.6f} scratch_bytes={work.numel()}",
          flush=True)
    return dict(shape=tag, n=n, size=size, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def scatter_check(tag: str, it, vt, size: int):
    """The kernel against its plain version on the card, on the same inputs:
    bit-equal (NaN lanes as NaN) and deterministic. Returns the kernel's
    output and the max abs error over the finite lanes."""
    import torch

    from repro_torch.kernels import ref, stream_decode

    out1 = stream_decode.stream_scatter_add_cuda(it, vt, size)
    out2 = stream_decode.stream_scatter_add_cuda(it, vt, size)
    torch.cuda.synchronize()
    plain = ref.stream_scatter_add_ref(it, vt, size)
    check(bits_equal_nan(out1, plain),
          f"stream_scatter_add != plain at {tag} (max abs "
          f"{max_err(out1, plain)})")
    check(bits_equal(out1, out2), f"stream_scatter_add not deterministic at "
          f"{tag}")
    return out1, max_err(out1, plain)


def kernel_phase(shapes, device) -> dict:
    import torch

    rows = {"stream_scatter_add": []}
    for tag, size, k, k_mask, C in shapes:
        n = C * (k + C * k_mask)
        # ---- scatter-add: adversarial correctness, then main-path timing
        idx, vals, p0 = scatter_inputs(n, size, seed=size % 9973,
                                       adversarial=True)
        out, err = scatter_check(tag, torch.from_numpy(idx).to(device),
                                 torch.from_numpy(vals).to(device), size)
        check(out[p0].item() == 0.0,
              f"order-sensitive triple folded out of order at {tag}")
        idx, vals, _ = scatter_inputs(n, size, seed=size % 9973 + 1,
                                      adversarial=False)
        it = torch.from_numpy(idx).to(device)
        vt = torch.from_numpy(vals).to(device)
        scatter_check(f"{tag} (clean stream)", it, vt, size)
        print(f"[kernels] stream_scatter_add {tag}: bit-equal=yes "
              f"deterministic=yes triple=0.0", flush=True)
        rows["stream_scatter_add"].append(dict(
            scatter_row(tag, it, vt, size, device), max_abs_err=err))

    return rows


def segmented_masks() -> bool:
    """Whether this tree's pair-mask kernel takes a segment table (the
    round launch); its parent launched once per leaf."""
    from repro_torch.kernels import build

    return build.SOURCES["pair_mask_streams.cu"]["pair_mask_streams"][0] \
        == "pair_mask_round_launch"


def raw_mask_launch(seeds32, signs, rows: int, peers: int, flags: int,
                    alive, segs):
    """The pair-mask kernel's C entry, called as the wrapper calls it:
    ``segs`` one ``(idx, vals, nb, k_mask, m, leaf_id or -1)`` each, the
    outputs preallocated. Returns a function that launches once."""
    import ctypes

    import torch

    from repro_torch.kernels import build

    fn = build.kernel("pair_mask_streams")
    desc = []
    for oi, ov, nb, k_mask, m, leaf in segs:
        desc += [oi.data_ptr(), ov.data_ptr(), nb, k_mask, m, leaf]
    arr = (ctypes.c_longlong * len(desc))(*desc)

    def launch():
        build.check(fn(seeds32.data_ptr(), signs.data_ptr(),
                       None if alive is None else alive.data_ptr(), peers,
                       rows, peers, flags, -1.0, 2.0, arr, len(segs),
                       torch.cuda.current_stream().cuda_stream),
                    "pair_mask_streams")

    return launch


def flat_mask_rows(shapes, device) -> list:
    """The flat per-pair call (one segment on a segmented tree) at the
    main path's leaf shapes: the 15 unordered pairs of a 5-client round."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, mask_prng, ref

    out = []
    for tag, size, _, k_mask, C in shapes:
        n_pairs = C * (C + 1) // 2
        rs = np.random.RandomState(size % 7919)
        seeds = rs.randint(0, 2**32, size=n_pairs, dtype=np.int64)
        seeds[0], seeds[1] = 2**32 - 1, 2**32 - 2     # wrap-around seeds
        st = torch.from_numpy(seeds).to(device)
        sg = torch.from_numpy(
            rs.choice([-1.0, 0.0, 1.0], size=n_pairs).astype(np.float32)
        ).to(device)
        ki, kv = mask_prng.pair_mask_streams_cuda(st, sg, nb=1,
                                                  k_mask=k_mask, m=size)
        torch.cuda.synchronize()
        pi, pv = ref.pair_mask_stream_ref(st, sg, 1, k_mask, size,
                                          p=-1.0, q=2.0)
        check(bits_equal(ki, pi) and bits_equal(kv, pv),
              f"pair_mask_streams != plain at {tag}")
        err = (kv - pv).abs().max().item()
        s32 = (st & 0xFFFFFFFF).to(torch.int32)
        oi = torch.empty((n_pairs, 1, k_mask), dtype=torch.int32,
                         device=device)
        ov = torch.empty((n_pairs, 1, k_mask), device=device)
        if segmented_masks():
            launch_masks = raw_mask_launch(s32, sg, n_pairs, 1, 0, None,
                                           [(oi, ov, 1, k_mask, size, -1)])
        else:                         # the parent's per-pair entry
            masks = build.kernel("pair_mask_streams")

            def launch_masks():
                build.check(masks(s32.data_ptr(), sg.data_ptr(), n_pairs,
                                  k_mask, size, -1.0, 2.0, oi.data_ptr(),
                                  ov.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream),
                            "pair_mask_streams")
        ms = graph_ms(launch_masks)
        wrapper_ms = events_ms(lambda: mask_prng.pair_mask_streams_cuda(
            st, sg, nb=1, k_mask=k_mask, m=size))
        plain_ms = events_ms(lambda: ref.pair_mask_stream_ref(
            st, sg, 1, k_mask, size, p=-1.0, q=2.0))
        elems = n_pairs * k_mask
        bound_ms, bound_by = bound(8 * n_pairs + 8 * elems,
                                   MASK_OPS_PER_SLOT * elems)
        out.append(dict(
            shape=f"flat {tag}", n=elems, size=size, ms=ms,
            wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
        print(f"[kernels] pair_mask_streams flat {tag}: pairs={n_pairs} "
              f"k_mask={k_mask} m={size} bit-equal=yes ms={ms:.6f} "
              f"wrapper_ms={wrapper_ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f}", flush=True)
    return out


def model_round(model: str, C: int = 5):
    """A round's mask inputs at a model's leaves: the protocol's seed and
    sign matrices for clients 0..C-1 (round 3), client 1 dropped and its
    seeds recovered, one ``(1, k_mask, size, leaf_id)`` per leaf under the
    table2 protocol (mask ratio 0.01)."""
    from repro_torch.core.types import SecureAggConfig
    from repro_torch.models.paper_models import build_model
    from repro_torch.secagg.protocol import RoundProtocol

    sa = SecureAggConfig(mask_ratio=0.01)
    sizes = [x.numel() for x in build_model(model, device="meta")
             .params().values()]
    proto = RoundProtocol.setup(sa, list(range(C)), 3)
    seeds, signs = proto.pair_seed_matrix()
    rec = proto.recover_seeds([c for c in range(C) if c != 1], [1])
    alive = [c != 1 for c in range(C)]
    leaves = [(1, sa.k_mask_for(n, C), n, leaf)
              for leaf, n in enumerate(sizes)]
    return seeds, signs, rec, alive, leaves


def mask_round_rows(device) -> list:
    """The round launch at mnist_mlp's 4 leaves and VGG16's 54: every
    leaf's masks, then every leaf's recovery streams, each in one launch,
    bit-equal to the segmented plain version and to the per-leaf flat
    launches; the raw launch (CUDA graph), the round function with its
    wrapper, the plain version and the bound. On a tree without the round
    launch (its parent) the round is its per-leaf flat launches, timed the
    same way."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import mask_prng, ref

    out = []
    for model in ("mnist_mlp", "cifar_vgg16"):
        seeds, signs, rec, alive, leaves = model_round(model)
        C = seeds.shape[0]
        slots = sum(C * C * nb * k for nb, k, _, _ in leaves)
        bound_ms, bound_by = bound(8 * slots + 8 * C * C,
                                   MASK_OPS_PER_SLOT * slots)
        tag = f"{model} round ({len(leaves)} leaves)"
        if not segmented_masks():
            sd, gd = seeds.to(device), signs.to(device, torch.float32)

            def per_leaf():
                return [se.mask_streams_all_pairs(sd, gd, nb, k, m, p=-1.0,
                                                  q=2.0, leaf_id=leaf)
                        for nb, k, m, leaf in leaves]
            iu, ju = torch.triu_indices(C, C).to(device)
            flat = []
            for nb, k, m, leaf in leaves:
                tri = se._fold_seeds(sd, leaf)[iu, ju]
                s32 = (tri & 0xFFFFFFFF).to(torch.int32)
                ones = torch.ones(len(tri), device=device)
                oi = torch.empty((len(tri), nb, k), dtype=torch.int32,
                                 device=device)
                flat.append((s32, ones, oi, torch.empty_like(oi,
                             dtype=torch.float32), nb * k, m))
            from repro_torch.kernels import build
            fn = build.kernel("pair_mask_streams")

            def launch():
                for s32, ones, oi, ov, L, m in flat:
                    build.check(fn(s32.data_ptr(), ones.data_ptr(), len(s32),
                                   L, m, -1.0, 2.0, oi.data_ptr(),
                                   ov.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream),
                                "pair_mask_streams")
            ms = graph_ms(launch)
            wrapper_ms = events_ms(per_leaf)
            out.append(dict(shape=tag, n=slots, ms=ms, wrapper_ms=wrapper_ms,
                            plain_ms=None, library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=0.0))
            print(f"[kernels] pair_mask_streams {tag}, per-leaf launches "
                  f"(parent): slots={slots} launches={len(leaves)} "
                  f"ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"bound_ms={bound_ms:.6f}", flush=True)
            continue
        sd, gd = se.round_matrices(device, seeds, signs)
        rd, ad = se.round_matrices(device, rec, alive)
        before = mask_prng.launches
        got = se.mask_streams_round(sd, gd, leaves, p=-1.0, q=2.0)
        rgot = se.recovery_streams_round(rd, gd, ad, leaves, p=-1.0, q=2.0)
        torch.cuda.synchronize()
        check(mask_prng.launches - before == 2,
              f"{tag}: {mask_prng.launches - before} launches for the masks "
              f"and the recovery streams, expected 2")
        plain = ref.pair_mask_segments_ref(sd, gd, leaves, mirror=True)
        rplain = ref.pair_mask_segments_ref(rd, gd, leaves, alive=ad)
        err = 0.0
        for (nb, k, m, leaf), (i, v), (pi, pv), r, (ri, rv) in zip(
                leaves, got, plain, rgot, rplain):
            fi, fv = se.mask_streams_all_pairs(sd, gd, nb, k, m, p=-1.0,
                                               q=2.0, leaf_id=leaf)
            fr = se.dropout_cancel_streams_seeded(rd, gd, ad, nb, k, m,
                                                  p=-1.0, q=2.0, leaf_id=leaf)
            check(bits_equal(i, pi) and bits_equal(v, pv)
                  and bits_equal(r.indices, ri) and bits_equal(r.values, rv),
                  f"{tag}: the round launch != plain at leaf {leaf}")
            check(bits_equal(i, fi) and bits_equal(v, fv)
                  and bits_equal(r.indices, fr.indices)
                  and bits_equal(r.values, fr.values),
                  f"{tag}: the round launch != the flat launches at leaf "
                  f"{leaf}")
            err = max(err, (v - pv).abs().max().item(),
                      (r.values - rv).abs().max().item())
        for kind, flags, sdev, alive_d, args in (
                ("masks", mask_prng.MIRROR, sd, None, dict(mirror=True)),
                ("recovery", mask_prng.GATE | mask_prng.GLOBAL
                 | mask_prng.PAIR_MAJOR, rd, ad,
                 dict(alive=ad))):
            outs = (got if kind == "masks" else
                    [(r.indices, r.values) for r in rgot])
            launch = raw_mask_launch(
                sdev, gd, C, C, flags, alive_d,
                [(i, v, nb, k, m, leaf) for (i, v), (nb, k, m, leaf)
                 in zip(outs, leaves)])
            ms = graph_ms(launch)
            if kind == "masks":
                wrapper_ms = events_ms(lambda: se.mask_streams_round(
                    sd, gd, leaves, p=-1.0, q=2.0))
            else:
                wrapper_ms = events_ms(lambda: se.recovery_streams_round(
                    rd, gd, ad, leaves, p=-1.0, q=2.0))
            plain_ms = events_ms(lambda: ref.pair_mask_segments_ref(
                sdev, gd, leaves, **args), reps=3, inner=3)
            out.append(dict(shape=f"{tag} {kind}", n=slots, ms=ms,
                            wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=err))
            print(f"[kernels] pair_mask_streams {tag} {kind}: slots={slots} "
                  f"launches=1 bit-equal to plain and to {len(leaves)} flat "
                  f"launches=yes ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}",
                  flush=True)
    return out


def mask_path_probe(device) -> dict:
    """The mask path of one table2_quick round at mnist_mlp's 4 leaves (5
    clients), from the protocol's host matrices to the masks in the
    per-client layout with the top-1 override of inactive slots, as the
    encode runs it: the CUDA kernels and host-to-device copies
    (``torch.profiler``) and the time with the host (CUDA events). On the
    parent of the round launch: a copy, the masks and the override per
    leaf."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import streams as se

    seeds, signs, _, _, leaves = model_round("mnist_mlp")
    C = seeds.shape[0]
    gen = torch.Generator(device=device).manual_seed(0)
    accs = [torch.randn((C, 1, m), device=device, generator=gen)
            for _, _, m, _ in leaves]

    def override(m_idx, sg, acc, k_mask):
        top1 = torch.argmax(acc.abs(), -1).to(torch.int32)[..., None]
        active = torch.repeat_interleave(sg != 0.0, k_mask,
                                         dim=-1)[:, None, :]
        return torch.where(active, m_idx, top1)

    if hasattr(se, "mask_streams_round"):
        def call():
            sd, gd = se.round_matrices(device, seeds, signs)
            masks = se.mask_streams_round(sd, gd, leaves, p=-1.0, q=2.0)
            return [override(mi, gd, a, k) for (mi, _), a, (_, k, _, _)
                    in zip(masks, accs, leaves)]
    else:
        def call():
            out = []
            for a, (nb, k, m, leaf) in zip(accs, leaves):
                gd = signs.to(device, torch.float32)
                mi, _ = se.mask_streams_all_pairs(
                    seeds.to(device), gd, nb, k, m, p=-1.0, q=2.0,
                    leaf_id=leaf)
                out.append(override(mi, gd, a, k))
            return out

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_events = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
    kernels = [n for n in device_events
               if not n.startswith(("Memcpy", "Memset"))]
    h2d = [n for n in device_events if "HtoD" in n]
    mask_kernels = [n for n in kernels if "pair_mask" in n]
    ms = events_ms(call)
    out = {"kernels": len(kernels), "mask_kernels": len(mask_kernels),
           "h2d_copies": len(h2d), "ms": ms}
    print(f"[masks] one table2_quick round's mask path (mnist_mlp, "
          f"{len(leaves)} leaves, C={C}, top-1 override included): "
          f"{len(kernels)} CUDA kernels ({len(mask_kernels)} of the "
          f"pair-mask kernel), {len(h2d)} host-to-device copies, {ms:.6f} "
          f"ms with the host; kernels: {'; '.join(kernels)}", flush=True)
    return out


def scatter_tree_group_row(device) -> dict:
    """One tree group's buffer at tree_quick's ``l0.w``, built as
    ``core/streams.py::_scatter_range`` builds it: the round's stream with
    the slots outside the middle group's range sent to position ``width`` of
    a ``width + 1`` buffer with value +0.0 (about two thirds of the slots).
    Bit-equal to the plain version, deterministic, the dump slot +0.0; then
    timed as the other shapes."""
    import numpy as np
    import torch

    from repro_torch.core import schedules
    from repro_torch.core import streams as se
    from repro_torch.models.paper_models import build_model
    from repro_torch.sim import presets

    cfg = presets.get("tree_quick")
    model = build_model(cfg.model)
    names = model.leaf_names()
    sizes = [model.params()[n].numel() for n in names]
    i = names.index("l0.w")
    C, size = cfg.clients_per_round, sizes[i]
    k = schedules.leaf_ks(cfg.thgs, sizes, t=0, total_rounds=cfg.rounds)[i]
    n = C * (k + C * cfg.sa.k_mask_for(size, C))
    lo, hi = se.tree_splits(size, cfg.tree_groups)[1:3]
    width = hi - lo
    idx, vals, _ = scatter_inputs(n, size, seed=4242, adversarial=False)
    inside = (idx >= lo) & (idx < hi)
    idx = np.where(inside, idx - lo, width).astype(np.int32)
    vals = np.where(inside, vals, np.float32(0.0)).astype(np.float32)
    tag = f"tree_quick.l0.w.group1(width+1={width + 1})"
    it = torch.from_numpy(idx).to(device)
    vt = torch.from_numpy(vals).to(device)
    out, err = scatter_check(tag, it, vt, width + 1)
    check(out[width].view(torch.int32).item() == 0,
          f"the dump slot is not +0.0 at {tag}")
    print(f"[kernels] stream_scatter_add {tag}: slots={n} dumped="
          f"{int((~inside).sum())} bit-equal=yes deterministic=yes "
          f"dump slot=+0.0", flush=True)
    # the plain version folds the dump slot's multiplicity one pass at a
    # time (seconds a call): timed over one call
    return dict(scatter_row(tag, it, vt, width + 1, device, plain_reps=1),
                max_abs_err=err)


def scatter_cases(device) -> None:
    """Correctness-only inputs for the scatter, each against its plain
    version on the card: a stream all in one tile, one position reached by
    12,000 non-zero order-sensitive entries, an all-zero stream with -0.0
    slots and padding, +-inf and NaN among zeros, n = 0, size = 1, a size
    that is no multiple of any tile, n below one chunk, and an output of
    more than 8192 tiles (the fold accumulates in the output)."""
    import numpy as np
    import torch

    rs = np.random.RandomState(15)

    def rand(n, lo, hi):
        return (rs.randint(lo, hi, n).astype(np.int32),
                rs.randn(n).astype(np.float32))

    cases = [("one-tile", *rand(100_000, 0, 200), 156_800)]
    idx, vals = rand(60_000, 0, 50_000)
    hot = rs.choice(60_000, 12_000, replace=False)
    idx[hot] = 777
    vals[hot] = (rs.randn(12_000)
                 * np.exp2(rs.randint(-20, 20, 12_000))).astype(np.float32)
    cases.append(("hot-position", idx, vals, 50_000))
    idx = rs.randint(-3, 1000, 9000).astype(np.int32)
    vals = np.where(rs.rand(9000) < 0.5, 0.0, -0.0).astype(np.float32)
    cases.append(("all-zero", idx, vals, 997))
    idx, vals = rand(20_000, 0, 3000)
    sp = rs.choice(20_000, 300, replace=False)
    vals[sp] = rs.choice(np.array([np.inf, -np.inf, np.nan, 0.0, -0.0],
                                  np.float32), 300)
    cases.append(("inf-nan", idx, vals, 3000))
    cases.append(("n0", np.zeros(0, np.int32), np.zeros(0, np.float32), 100))
    cases.append(("size1", *rand(5000, -1, 2), 1))
    cases.append(("size1000003", *rand(300_000, -1, 1_000_004), 1_000_003))
    cases.append(("n100", *rand(100, -1, 700), 700))
    idx, vals = rand(20_000, 0, 300)
    cases.append(("size40M", idx * 100_003, vals, 40_000_000))
    for tag, idx, vals, size in cases:
        out, _ = scatter_check(tag, torch.from_numpy(idx).to(device),
                               torch.from_numpy(vals).to(device), size)
        check(tag != "all-zero" or not torch.signbit(out).any().item(),
              "an all-zero stream gave a -0.0")
    print(f"[kernels] stream_scatter_add correctness cases bit-equal to the "
          f"plain version (NaN lanes as NaN) and deterministic: "
          f"{', '.join(c[0] for c in cases)}", flush=True)


def pack_fields(rs, R: int, k: int, width: int, device):
    """uint32 fields below 2**width (int64 lanes) with 0 and the maximum in
    the first row."""
    import numpy as np
    import torch

    u = rs.randint(0, 2**32, (R, k), dtype=np.uint64) >> np.uint64(32 - width)
    u[0, :2] = [0, 2**width - 1]
    return torch.from_numpy(u.astype(np.int64)).to(device)


# the codec path's two-segment leaves: (tag, R, k, index width, value width)
PACK_LEAF_PAIRS = (("mnist_mlp.l0.w.int8", 5, 7880, 18, 8),
                   ("cifar_vgg16.512x512x3x3.1bit", 5, 60199, 22, 1))


def pack_pair_rows(rs, device) -> dict:
    """Each leaf pair packed and unpacked as ONE segmented launch, bit-equal
    to the plain versions with one launch counted a call; raw launch ms (a
    CUDA graph), wrapper ms and plain ms beside the bound of both segments.
    On a tree without the segmented launches (the parent, for a comparison
    in one call) the pair is two single-segment launches, as its codec path
    runs it."""
    import torch

    from repro_torch.kernels import build, ops, pack, ref

    segmented = hasattr(ops, "bitpack_segments")
    rows = {"bitpack_rows": [], "bitunpack_rows": []}
    for tag, R, k, wi, wv in PACK_LEAF_PAIRS:
        widths = [wi, wv]
        fields = [pack_fields(rs, R, k, w, device) for w in widths]
        plain_w = [ref.bitpack_rows_ref(u, w) for u, w in zip(fields, widths)]
        words_n = [ref.packed_words(k, w) for w in widths]
        f32 = [(u & ref.M32).to(torch.int32) for u in fields]
        w32 = [(x & ref.M32).to(torch.int32) for x in plain_w]
        if segmented:
            n0, m0 = pack.pack_launches, pack.unpack_launches
            words = ops.bitpack_segments(f32, widths=widths)
            back = ops.bitunpack_segments(words, ks=[k, k], widths=widths)
            torch.cuda.synchronize()
            check((pack.pack_launches - n0, pack.unpack_launches - m0)
                  == (1, 1), f"{tag}: a segmented call launched "
                  f"{pack.pack_launches - n0} / {pack.unpack_launches - m0} "
                  "times, expected 1 / 1")
            words = [x.to(torch.int64) & ref.M32 for x in words]
            back = [x.to(torch.int64) & ref.M32 for x in back]
        else:
            words = [pack.bitpack_rows_cuda(u, w)
                     for u, w in zip(fields, widths)]
            back = [pack.bitunpack_rows_cuda(x, k, w)
                    for x, w in zip(words, widths)]
            torch.cuda.synchronize()
        for x, y, u, pw, w in zip(words, back, fields, plain_w, widths):
            check(bits_equal(x, pw), f"bitpack {tag} w={w} != plain")
            check(bits_equal(y, ref.bitunpack_rows_ref(pw, k, w))
                  and bits_equal(y, u), f"bitunpack {tag} w={w} != plain "
                  "or no round trip")
        out_w = [torch.empty((R, W), dtype=torch.int32, device=device)
                 for W in words_n]
        out_u = [torch.empty((R, k), dtype=torch.int32, device=device)
                 for _ in widths]
        err = max(max((x - pw).abs().max().item() for x, pw in
                      zip(words, plain_w)),
                  max((y - u).abs().max().item() for y, u in
                      zip(back, fields)))

        def stream():                 # the capture stream inside a graph
            return torch.cuda.current_stream().cuda_stream

        if segmented:
            import ctypes

            def desc(srcs, outs, W_of):
                d = []
                for i, w in enumerate(widths):
                    d += [srcs[i].data_ptr(), outs[i].data_ptr(), R, k, w,
                          W_of[i]]
                return (ctypes.c_longlong * len(d))(*d)

            dp = desc(f32, out_w, words_n)
            du = desc(w32, out_u, words_n)
            fp = build.kernel("bitpack_segments")
            fu = build.kernel("bitunpack_segments")

            def launch_pack():
                build.check(fp(dp, 2, stream()), "bitpack_segments")

            def launch_unpack():
                build.check(fu(du, 2, stream()), "bitunpack_segments")

            def wrap_pack():
                ops.bitpack_segments(f32, widths=widths)

            def wrap_unpack():
                ops.bitunpack_segments(w32, ks=[k, k], widths=widths)
        else:
            fp = build.kernel("bitpack_rows")
            fu = build.kernel("bitunpack_rows")

            def launch_pack():
                for i, w in enumerate(widths):
                    build.check(fp(f32[i].data_ptr(), R, k, w,
                                   out_w[i].data_ptr(), words_n[i],
                                   stream()),
                                "bitpack_rows")

            def launch_unpack():
                for i, w in enumerate(widths):
                    build.check(fu(w32[i].data_ptr(), R, words_n[i], k, w,
                                   out_u[i].data_ptr(), stream()),
                                "bitunpack_rows")

            def wrap_pack():
                for u, w in zip(fields, widths):
                    pack.bitpack_rows_cuda(u, w)

            def wrap_unpack():
                for x, w in zip(plain_w, widths):
                    pack.bitunpack_rows_cuda(x, k, w)

        nbytes = sum(4 * R * k + 4 * R * W for W in words_n)
        launches_per_call = 1 if segmented else 2
        for name, launch, wrapper, plain_fn in (
                ("bitpack_rows", launch_pack, wrap_pack,
                 lambda: [ref.bitpack_rows_ref(u, w)
                          for u, w in zip(fields, widths)]),
                ("bitunpack_rows", launch_unpack, wrap_unpack,
                 lambda: [ref.bitunpack_rows_ref(x, k, w)
                          for x, w in zip(plain_w, widths)])):
            ms = graph_ms(launch)
            wrapper_ms = events_ms(wrapper)
            plain_ms = events_ms(plain_fn, reps=3, inner=3)
            bound_ms, bound_by = bound(nbytes, PACK_OPS_PER_FIELD * 2 * R * k)
            rows[name].append(dict(
                shape=tag, R=R, k=k, width=widths, words=words_n,
                segments=2, launches_per_call=launches_per_call, ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
            print(f"[kernels] {name} {tag} pair: R={R} k={k} w={widths} "
                  f"W={words_n} launches_per_call={launches_per_call} "
                  f"bit-equal=yes ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} "
                  f"library=none", flush=True)
    return rows


def pack_kernel_phase(device) -> dict:
    """The bit-pack kernels: every width 1..32, the four single-segment
    shapes and the two leaf pairs (first in the returned rows: the pairs
    are what the codec path launches)."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, pack, ref

    rs = np.random.RandomState(12)
    for width in range(1, 33):
        u = pack_fields(rs, 3, 75, width, device)
        words = pack.bitpack_rows_cuda(u, width)
        back = pack.bitunpack_rows_cuda(words, 75, width)
        torch.cuda.synchronize()
        plain = ref.bitpack_rows_ref(u, width)
        check(bits_equal(words, plain), f"bitpack_rows != plain at w={width}")
        check(bits_equal(back, ref.bitunpack_rows_ref(plain, 75, width))
              and bits_equal(back, u),
              f"bitunpack_rows != plain or no round trip at w={width}")
    print("[kernels] bitpack_rows / bitunpack_rows: widths 1..32 at R=3 "
          "k=75 bit-equal=yes round-trip=yes", flush=True)
    rows = pack_pair_rows(rs, device)
    for tag, R, k, width in (("mnist_mlp.l0.w.index", 5, 7880, 18),
                             ("mnist_mlp.l0.w.int8", 5, 7880, 8),
                             ("cifar_vgg16.512x512x3x3.index", 5, 60199, 22),
                             ("cifar_vgg16.512x512x3x3.1bit", 5, 60199, 1)):
        W = ref.packed_words(k, width)
        u = pack_fields(rs, R, k, width, device)
        words = pack.bitpack_rows_cuda(u, width)
        back = pack.bitunpack_rows_cuda(words, k, width)
        torch.cuda.synchronize()
        plain_w = ref.bitpack_rows_ref(u, width)
        plain_u = ref.bitunpack_rows_ref(plain_w, k, width)
        check(bits_equal(words, plain_w), f"bitpack_rows != plain at {tag}")
        check(bits_equal(back, plain_u) and bits_equal(back, u),
              f"bitunpack_rows != plain or no round trip at {tag}")
        err_p = (words - plain_w).abs().max().item()
        err_u = (back - plain_u).abs().max().item()
        u32 = (u & ref.M32).to(torch.int32)
        w32 = (words & ref.M32).to(torch.int32)
        out_w = torch.empty((R, W), dtype=torch.int32, device=device)
        out_u = torch.empty((R, k), dtype=torch.int32, device=device)
        fpack = build.kernel("bitpack_rows")
        funpack = build.kernel("bitunpack_rows")

        def launch_pack():
            build.check(fpack(u32.data_ptr(), R, k, width, out_w.data_ptr(),
                              W, torch.cuda.current_stream().cuda_stream),
                        "bitpack_rows")

        def launch_unpack():
            build.check(funpack(w32.data_ptr(), R, W, k, width,
                                out_u.data_ptr(),
                                torch.cuda.current_stream().cuda_stream),
                        "bitunpack_rows")

        nbytes = 4 * R * k + 4 * R * W
        for name, launch, wrapper, plain_fn, err in (
                ("bitpack_rows", launch_pack,
                 lambda: pack.bitpack_rows_cuda(u, width),
                 lambda: ref.bitpack_rows_ref(u, width), err_p),
                ("bitunpack_rows", launch_unpack,
                 lambda: pack.bitunpack_rows_cuda(words, k, width),
                 lambda: ref.bitunpack_rows_ref(words, k, width), err_u)):
            ms = graph_ms(launch)
            wrapper_ms = events_ms(wrapper)
            plain_ms = events_ms(plain_fn, reps=3, inner=3)
            bound_ms, bound_by = bound(nbytes, PACK_OPS_PER_FIELD * R * k)
            rows[name].append(dict(
                shape=tag, R=R, k=k, width=width, words=W, ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
            print(f"[kernels] {name} {tag}: R={R} k={k} w={width} W={W} "
                  f"bit-equal=yes ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} "
                  f"library=none", flush=True)
    return rows


# ----------------------------------------------- phase 2: thgs + mask apply
# (tag, elements): VGG16's largest leaf, the main path's l0.w, odd sizes
SPLIT_SIZES = (("cifar_vgg16.512x512x3x3", 2359296),
               ("mnist_mlp.l0.w", 156800), ("n1", 1), ("n97", 97), ("n255", 255), ("n257", 257),
               ("n50000", 50000))
DELTA = 0.1                 # not f32-exact: a tie at f32(0.1) is not kept
MASK_PQ = ((-1.0, 2.0), (-1.5, 3.0), (-0.7, 1.3))
# mix32 outputs whose uint32 -> f32 conversion rounds: around 2^24 and 2^25
# multiples (ties to even both ways), odd values near 2^32, and 0xFFFFFFFF,
# which rounds to 2^32 (u = p + q exactly)
U32_PROBES = (0, 2**24 - 1, 2**24 + 1, 2**24 + 3, 2**25 + 2, 2**25 + 6,
              2**31 + 1, 2**31 + 128, 2**31 + 384, 2**32 - 129, 2**32 - 128,
              2**32 - 127, 2**32 - 3, 2**32 - 1)


def unmix32(y: int) -> int:
    """Inverse of the murmur finalizer mix32 (a bijection on uint32)."""
    m = 2**32
    y ^= y >> 16
    y = y * pow(0x846CA68B, -1, m) % m
    y ^= (y >> 15) ^ (y >> 30)
    y = y * pow(0x7FEB352D, -1, m) % m
    return y ^ (y >> 16)


def bits_equal_nan(a, b) -> bool:
    """Bit-equal, except that a NaN matches any NaN (payloads differ between
    the x86 default NaN, torch's and CUDA's conversions)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ia = a.view(torch.int32 if a.dtype == torch.float32 else torch.int16)
    ib = b.view(ia.dtype)
    return torch.equal(ia[~na], ib[~nb])


def max_err(a, b) -> float:
    import torch

    d = (a.float() - b.float()).abs()
    d = d[torch.isfinite(d)]
    return d.max().item() if d.numel() else 0.0


def split_inputs(n: int, seed: int, g_dtype, r_dtype, device):
    """g ~ N(0, 1), r ~ N(0, 0.04), with planted ties at f32(DELTA) (when r
    is f32), +-inf accumulators and a -0.0 accumulator."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    g = rs.randn(n).astype(np.float32)
    r = (0.2 * rs.randn(n)).astype(np.float32)
    if n >= 8:
        d32 = np.float32(DELTA)
        g[:8] = [0.09375, -0.09375, np.inf, -np.inf, -0.0, d32, 2.0, -3.0]
        r[:8] = [d32 - np.float32(0.09375), np.float32(0.09375) - d32, 1.0,
                 -1.0, -0.0, 0.0, 0.5, 0.25]
    return (torch.from_numpy(g).to(device).to(g_dtype),
            torch.from_numpy(r).to(device).to(r_dtype))


def split_mask_kernel_phase(device) -> tuple[dict, dict]:
    """thgs_sparsify and mask_prng_apply: bit-equal to their plain versions
    (compared as bits) at VGG16's largest leaf, mnist_mlp's l0.w and odd
    sizes; then driven through ``ops`` over every leaf of both models with
    the counts reset before and read after; then timed."""
    import torch

    from repro_torch.core import schedules
    from repro_torch.core.types import THGSConfig
    from repro_torch.kernels import build, mask_prng, ops, ref
    from repro_torch.kernels import thgs_sparsify as thgs
    from repro_torch.models.paper_models import build_model

    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"thgs_sparsify": 0.0, "mask_prng_apply": 0.0}
    # ---- correctness: every size, dtype pair and threshold kind
    for i, (tag, n) in enumerate(SPLIT_SIZES):
        pairs = ((f32, f32), (bf16, bf16)) if n > 10**6 else (
            (f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16))
        for j, (gd, rd) in enumerate(pairs):
            g, r = split_inputs(n, 10 * i + j, gd, rd, device)
            thr = (torch.tensor(DELTA, dtype=f32, device=device) if j % 2 == 0
                   else DELTA)
            sk, rk = thgs.thgs_sparsify_cuda(g, r, thr)
            torch.cuda.synchronize()
            sp, rp = ref.thgs_sparsify_ref(g, r, DELTA)
            check(bits_equal_nan(sk, sp) and bits_equal_nan(rk, rp),
                  f"thgs_sparsify != plain at {tag} {gd}/{rd}")
            if n >= 8 and rd == f32:
                check(sk[0].item() == 0.0
                      and (gd != f32 or sk[5].item() == 0.0)
                      and sk[2].item() == float("inf")
                      and torch.isnan(rk[2:4].float()).all().item()
                      and rk[4].float().item() == 0.0
                      and torch.signbit(rk[4].float()).item(),
                      f"thgs_sparsify tie / inf / -0.0 cases wrong at {tag}")
            errs["thgs_sparsify"] = max(errs["thgs_sparsify"],
                                        max_err(sk, sp), max_err(rk, rp))
        gens = torch.Generator(device=device).manual_seed(500 + i)
        for gd in ((f32, bf16) if n >= 156800 else (f32,)):
            g = torch.randn(n, generator=gens, device=device).to(gd)
            for p, q in MASK_PQ:
                for sign in (1.0, -1.0):
                    for sigma in (p + 0.25 * q, 10.0):
                        ok, mk = mask_prng.mask_prng_apply_cuda(
                            g, 1234 + i, p=p, q=q, sigma=sigma, sign=sign)
                        torch.cuda.synchronize()
                        op, mp = ref.mask_prng_ref(g, 1234 + i, p=p, q=q,
                                                   sigma=sigma, sign=sign)
                        check(bits_equal(mk, mp) and bits_equal_nan(ok, op),
                              f"mask_prng_apply != plain at {tag} {gd} "
                              f"p={p} q={q} sign={sign} sigma={sigma}")
                        errs["mask_prng_apply"] = max(
                            errs["mask_prng_apply"], max_err(ok, op),
                            max_err(mk, mp))
        print(f"[kernels] thgs_sparsify / mask_prng_apply {tag}: n={n} "
              f"bit-equal=yes (dtype pairs, delta={DELTA} as a device "
              f"tensor and as a float, ties, +-inf, -0.0; p/q {MASK_PQ}, "
              f"both signs)", flush=True)
    g = torch.zeros(8, device=device)
    for pos, x in enumerate(U32_PROBES):
        seed = unmix32(x) ^ (pos % 8)
        for p, q in MASK_PQ:
            _, mk = mask_prng.mask_prng_apply_cuda(g, seed, p=p, q=q,
                                                   sigma=10.0, sign=-1.0)
            _, mp = ref.mask_prng_ref(g, seed, p=p, q=q, sigma=10.0,
                                      sign=-1.0)
            torch.cuda.synchronize()
            check(bits_equal(mk, mp), f"mask_prng_apply u32 probe {x:#x}")
            if x == 2**32 - 1:
                want = -torch.tensor(p, dtype=f32) - torch.tensor(q, dtype=f32)
                check(mk[pos % 8].item() == want.item(),
                      f"0xFFFFFFFF did not give u = p + q at p={p} q={q}")
    print(f"[kernels] mask_prng_apply uint32->f32 probes "
          f"{[hex(x) for x in U32_PROBES]}: bit-equal=yes, 0xFFFFFFFF gives "
          f"u = p + q", flush=True)

    # ---- the ops path: every leaf of mnist_mlp and VGG16 through the public
    # entries (no reference path calls these two kernels): the THGS split at
    # the round-0 top-k threshold, computed on the card, then a pair's two
    # masks, which cancel exactly
    thgs_cfg = THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    n_leaves = 0
    checks = []
    for model in ("mnist_mlp", "cifar_vgg16"):
        m = build_model(model)
        shapes = {n: tuple(t.shape) for n, t in m.params().items()}
        names = m.leaf_names()
        ks = schedules.leaf_ks(thgs_cfg, [m.params()[n].numel()
                                          for n in names], t=0,
                               total_rounds=12)
        gen = torch.Generator(device=device).manual_seed(7)
        for leaf_id, (name, k) in enumerate(zip(names, ks)):
            g = torch.randn(shapes[name], generator=gen, device=device)
            r = 0.1 * torch.randn(shapes[name], generator=gen, device=device)
            acc = (g + r).reshape(-1)
            delta = torch.topk(acc.abs(), min(k, acc.numel())).values[-1]
            sparse, resid = ops.thgs_sparsify(g, r, delta)
            seed = (0x5EED0000 + leaf_id) & 0xFFFFFFFF
            masked, mask = ops.mask_prng_apply(sparse, seed=seed, sigma=-0.98)
            _, peer = ops.mask_prng_apply(torch.zeros_like(sparse), seed=seed,
                                          sigma=-0.98, sign=-1.0)
            checks.append((name, g, r, delta, sparse, resid, seed, masked,
                           mask, peer))
            n_leaves += 1
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name, g, r, delta, sparse, resid, seed, masked, mask, peer in checks:
        sp, rp = ref.thgs_sparsify_ref(g, r, delta)
        mo, mp = ref.mask_prng_ref(sparse, seed, p=-1.0, q=2.0, sigma=-0.98)
        check(bits_equal(sparse, sp) and bits_equal(resid, rp)
              and bits_equal(masked, mo) and bits_equal(mask, mp),
              f"ops path differs from the plain versions at {name}")
        check(torch.equal(mask + peer, torch.zeros_like(mask)),
              f"a pair's masks do not cancel at {name}")
    del checks
    print(f"[kernels] ops path over {n_leaves} leaves of mnist_mlp and "
          f"cifar_vgg16 (top-k threshold on the card, a pair's two masks): "
          f"launches thgs_sparsify={counts['thgs_sparsify']} "
          f"mask_prng_apply={counts['mask_prng_apply']}, bit-equal to the "
          f"plain versions, masks cancel exactly", flush=True)
    check(counts["thgs_sparsify"] == n_leaves
          and counts["mask_prng_apply"] == 2 * n_leaves,
          f"ops path launches {counts} for {n_leaves} leaves")

    # ---- times at VGG16's largest leaf: raw launches in a CUDA graph over
    # enough buffer sets (> 150 MB) that every launch reads from HBM, not
    # from the 50 MB L2; the wrapper's whole call; the plain version
    rows = {"thgs_sparsify": [], "mask_prng_apply": []}
    n = SPLIT_SIZES[0][1]
    fsplit = build.kernel("thgs_sparsify")
    fmask = build.kernel("mask_prng_apply")
    for dt in (f32, bf16):
        code = build.DTYPE_CODES[dt]
        esz = torch.tensor([], dtype=dt).element_size()
        n_sets = max(2, -(-150_000_000 // (4 * esz * n)))
        sets = []
        for i in range(n_sets):
            g, r = split_inputs(n, 99 + i, dt, dt, device)
            sets.append((g, r, torch.empty_like(g), torch.empty_like(r),
                         torch.empty(n, dtype=f32, device=device)))
        thr = torch.tensor([DELTA], dtype=f32, device=device)
        turn = [0]

        def next_set():
            turn[0] += 1
            return sets[turn[0] % n_sets]

        def launch_split():
            g, r, so, ro, _ = next_set()
            build.check(fsplit(g.data_ptr(), r.data_ptr(), thr.data_ptr(),
                               0.0, n, code, code, so.data_ptr(),
                               ro.data_ptr(),
                               torch.cuda.current_stream().cuda_stream),
                        "thgs_sparsify")

        def launch_mask():
            g, _, so, _, mo = next_set()
            build.check(fmask(g.data_ptr(), n, 1234, -1.5, 3.0, -0.75, 1.0,
                              code, so.data_ptr(), mo.data_ptr(),
                              torch.cuda.current_stream().cuda_stream),
                        "mask_prng_apply")

        g, r = sets[0][:2]
        for name, launch, wrapper, plain, nbytes, nops in (
                ("thgs_sparsify", launch_split,
                 lambda: thgs.thgs_sparsify_cuda(g, r, thr),
                 lambda: ref.thgs_sparsify_ref(g, r, thr),
                 4 * esz * n + 4, 3 * n),
                ("mask_prng_apply", launch_mask,
                 lambda: mask_prng.mask_prng_apply_cuda(
                     g, 1234, p=-1.5, q=3.0, sigma=-0.75),
                 lambda: ref.mask_prng_ref(g, 1234, p=-1.5, q=3.0,
                                           sigma=-0.75),
                 (2 * esz + 4) * n, 24 * n)):
            ms = graph_ms(launch, inner=4 * n_sets)
            wrapper_ms = events_ms(wrapper)
            plain_ms = events_ms(plain, reps=3, inner=3)
            bound_ms, bound_by = bound(nbytes, nops)
            rows[name].append(dict(
                shape=f"{SPLIT_SIZES[0][0]}.{str(dt)[6:]}", n=n, ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs[name], bytes=nbytes))
            print(f"[kernels] {name} {SPLIT_SIZES[0][0]} {str(dt)[6:]}: "
                  f"n={n} graph_ms={ms:.6f} (cold: {n_sets} buffer sets) "
                  f"wrapper_ms={wrapper_ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={bound_ms:.6f} ({bound_by}: "
                  f"{nbytes / 1e6:.2f} MB, {nbytes / ms / 1e9:.3f} TB/s) "
                  f"library=none", flush=True)
        del sets
    return rows, counts


# ------------------------------------------------------------------ phase 4
def plain_unmasked_sum(info) -> "object":
    """The survivors' weighted sparse sum without masks, from the round's own
    encode inputs and stream indices, with the plain versions on the host."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import ref

    acc = (info["residuals"].float() + info["updates"].float()).cpu()
    C = acc.shape[0]
    acc = acc.reshape(C, -1)
    idx = info["streams"].indices.cpu().reshape(C, -1).to(torch.int64)
    first = se.first_occurrence_rows(idx)
    w = info["weights"].cpu()
    vals = w[:, None] * torch.gather(acc, 1, idx) * first.float()
    alive = info["alive"].cpu()
    return ref.stream_scatter_add_ref(idx[alive].reshape(-1),
                                      vals[alive].reshape(-1), acc.shape[1])


def clone_info(info) -> dict:
    import torch

    out = {}
    for key, v in info.items():
        if torch.is_tensor(v):
            v = v.clone()
        elif hasattr(v, "indices"):                       # a StreamBatch
            v = type(v)(v.indices.clone(), v.values.clone())
        out[key] = v
    return out


# ------------------------------------------------------------------ phase 6
def codec_phase(kind: str) -> dict:
    """codec_sweep_quick on the card; returns the sweep's launch counts."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    arms = presets.sweep_configs("codec_sweep_quick")
    results = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for codec, cfg in arms.items():
        sim = Simulation(cfg.replace(out_json=None), device="cuda")
        probe = {}

        def first_leaf(leaf_id, name, info, probe=probe):
            if name == "l0.w" and not probe:
                probe.update(clone_info(info), leaf_id=leaf_id)

        sim.leaf_hook = first_leaf
        before = ops.launch_counts()
        res = sim.run()
        after = ops.launch_counts()
        check(all(torch.isfinite(p).all() for p in sim.state.params.values()),
              f"non-finite parameters in the {codec} arm")
        results[codec] = (res, {n: after[n] - before[n] for n in after},
                          probe)
    sweep_counts = ops.launch_counts()
    base = {a: results["f32"][0].ledger.totals(a)["upload_bits"]
            for a in ("paper", "tpu")}
    for codec, (res, counts, probe) in results.items():
        tp, tt = res.ledger.totals("paper"), res.ledger.totals("tpu")
        # round 0's l0.w, replayed on the CPU with the plain versions
        cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
               for k, v in probe.items()}
        size = cpu["size"]
        st, nr = se.encode_leaf_batch(
            cpu["updates"], cpu["residuals"], k=cpu["k"], nb=1, m=size,
            size=size, leaf_id=cpu["leaf_id"], weights=cpu["weights"],
            codec=codec)
        dense = se.decode_leaf_batch(st, nb=1, m=size, size=size)
        card_st = probe["streams"]
        idx_same = bits_equal(st.indices, card_st.indices.cpu())
        if codec == "1bit":
            cv, cn = card_st.values.cpu(), cpu["new_residuals"]
            gap = (cv.abs() - st.values.abs()).abs().max().item()
            same = (idx_same and torch.equal(cv.sign(), st.values.sign())
                    and gap <= ONE_BIT_REL * st.values.abs().max().item()
                    and (cn - nr).abs().max().item()
                    <= gap + nr.abs().max().item() * 2.0 ** -23)
            how = (f"indices bit-equal, values within 4 ulp "
                   f"(max |d|scale| {gap:.3e}): {same}")
        else:
            same = (idx_same and bits_equal(st.values, card_st.values.cpu())
                    and bits_equal(nr, cpu["new_residuals"])
                    and bits_equal(dense, cpu["dense"]))
            how = f"streams, residuals and decoded sum bit-equal: {same}"
        print(f"[codec] {codec:4s} on {kind}: rounds={res.rounds} upload "
              f"paper {tp['upload_mib']:.6f} MiB "
              f"({tp['upload_bits'] / base['paper']:.4%} of f32) tpu "
              f"{tt['upload_mib']:.6f} MiB "
              f"({tt['upload_bits'] / base['tpu']:.4%} of f32) "
              f"final_acc={res.final_acc:.4f} wall_s={res.wall_s:.4f} "
              f"launches={counts}", flush=True)
        print(f"[codec] {codec:4s} round 0 l0.w (k={cpu['k']}) replayed on "
              f"the CPU: {how}", flush=True)
        check(same, f"the card's round-0 l0.w {codec} encode differs from "
              "the CPU replay")
        n_leaves = len(res.ledger.entries[0].ks)
        # one segmented pack and one unpack launch a leaf: both streams
        want = 0 if codec == "f32" else n_leaves * res.rounds
        check(counts["bitpack_rows"] == want
              and counts["bitunpack_rows"] == want,
              f"{codec} arm launched the pack kernels {counts}, expected "
              f"{want} each")
        if codec != "f32":
            check(tp["upload_bits"] < base["paper"]
                  and tt["upload_bits"] < base["tpu"],
                  f"{codec} uploads no less than f32")
        check(res.final_acc >= 0.9, f"{codec} final_acc {res.final_acc:.4f}")
    check(tuple(results) == ("f32", "int8", "int4", "1bit"), "arms")
    check(results["int8"][0].ledger.totals("paper")["upload_bits"] * 3
          <= base["paper"], "int8 above a third of the f32 upload (paper)")
    print(f"[codec] codec_sweep_quick launches={sweep_counts}", flush=True)
    for name in ("bitpack_rows", "bitunpack_rows"):
        check(sweep_counts[name] == 144,
              f"{name} launched {sweep_counts[name]} times, expected 144")
    wire_roundtrip_probe(torch.device("cuda:0"))
    return sweep_counts


def wire_roundtrip_probe(device) -> dict:
    """One ``codec_wire_roundtrip`` call at mnist_mlp's ``l0.w`` under the
    int8 codec (5 clients, k = 7,880 of 156,800): the CUDA kernels it runs,
    counted on the card with ``torch.profiler`` (copies apart), and its time
    with the host's share (CUDA events). Runs on any tree of the port, so
    a parent and a change can be counted in one call."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import streams as se

    rs = np.random.RandomState(5)
    C, k, m = 5, 7880, 156800
    gidx = torch.from_numpy(np.stack([rs.choice(m, k, replace=False)
                                      for _ in range(C)])
                            .astype(np.int32)[:, None, :]).to(device)
    vals = torch.from_numpy(rs.randn(C, 1, k).astype(np.float32)).to(device)
    cols, q, scales, _ = se.codec_wire_stage(
        gidx, vals, torch.zeros((C, 1, m), device=device), None, m, "int8")

    def call():
        return se.codec_wire_roundtrip(cols, q, scales, m, "int8")

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_events = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
    kernels = [n for n in device_events
               if not n.startswith(("Memcpy", "Memset"))]
    runtime = sum(1 for e in prof.events()
                  if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    ms = events_ms(call)
    out = {"kernels": len(kernels), "copies": len(device_events)
           - len(kernels), "launch_calls": runtime, "ms": ms}
    print(f"[codec] one codec_wire_roundtrip (mnist_mlp l0.w, int8, C={C} "
          f"k={k}): {len(kernels)} CUDA kernels, {out['copies']} copies, "
          f"{runtime} launch calls, {ms:.6f} ms with the host; kernels: "
          f"{'; '.join(kernels)}", flush=True)
    return out


# ------------------------------------------------------------------ phase 7
def plain_noised_sum(info, leaf_id: int):
    """The survivors' unmasked noised sum of a DP round's leaf: gradient on
    the released slots (once per index), plus each client's noise, with the
    plain versions on the card."""
    import torch

    from repro_torch.core import dp, streams as se
    from repro_torch.kernels import ref

    C, size = info["updates"].shape[0], info["size"]
    k_data = min(info["k"], size)
    acc = (info["residuals"].float() + info["updates"].float()).reshape(C, -1)
    idx = info["streams"].indices.reshape(C, -1).to(torch.int64)
    first = se.first_occurrence_rows(idx)
    first[:, k_data:] = False
    vals = torch.where(first, torch.gather(acc, 1, idx), 0.0)
    noise = dp.add_stream_noise(
        torch.zeros((C, 1, idx.shape[1]), device=acc.device),
        info["dp_seeds"], sigma=info["dp_sigma"], leaf_id=leaf_id,
        k_data=k_data).reshape(C, -1)
    alive = info["alive"]
    return ref.stream_scatter_add_ref(idx[alive].reshape(-1),
                                      (vals + noise)[alive].reshape(-1), size)


def dp_phase(kind: str) -> None:
    import torch

    from repro_torch.core.dp import DPConfig
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get("dp_quick").replace(out_json=None)
    sim = Simulation(cfg, device="cuda")
    captured = {}

    def leaf_hook(leaf_id, name, info):
        if info["dropped"] and name == "l0.w" and "info" not in captured:
            captured.update(info=clone_info(info), leaf_id=leaf_id)

    sim.leaf_hook = leaf_hook
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    counts = ops.launch_counts()
    priv = res.ledger.privacy()
    check("info" in captured, "dp_quick dropped no client")
    want = plain_noised_sum(captured["info"], captured["leaf_id"])
    err = (captured["info"]["dense"] - want).abs().max().item()
    tol = 64 * 2.0 ** -24
    print(f"[dp] dp_quick on {kind}: eps={priv['epsilon']:.6f} at "
          f"delta={priv['delta']:g} over {priv['rounds']} rounds "
          f"final_acc={res.final_acc:.4f} launches={counts} dropout round "
          f"{captured['info']['dropped']}: decoded vs plain unmasked noised "
          f"sum max abs err {err:.3e} (tolerance 64 * 2^-24 = {tol:.3e})",
          flush=True)
    check(round(priv["epsilon"], 1) == 40.1,
          f"dp_quick eps {priv['epsilon']:.4f} != 40.1")
    check(err <= tol, f"DP dropout round off by {err:.3e}")
    for name in ("stream_scatter_add", "pair_mask_streams"):
        check(counts[name] > 0, f"dp_quick never launched {name}")
    dropout_rounds = sum(e.n_survivors < cfg.clients_per_round
                         for e in res.ledger.entries)
    check(counts["pair_mask_streams"] == cfg.rounds + dropout_rounds,
          f"dp_quick launched the masks {counts['pair_mask_streams']} times, "
          f"expected {cfg.rounds} + {dropout_rounds} (one a round, one more "
          f"a dropout round)")

    want_eps = {"z0.3": 89.7, "z0.6": 33.7, "z1.2": 14.1}
    arms = presets.dp_sweep_configs("dp_frontier_quick")
    off_sim = None
    for label, cfg in arms.items():
        sim = Simulation(cfg.replace(out_json=None), device="cuda")
        res = sim.run()
        priv = res.ledger.privacy()
        eps = priv["epsilon"] if priv else float("inf")
        up = res.ledger.totals("paper")
        print(f"[dp] dp_frontier_quick {label:4s}: eps={eps:.6f} "
              f"final_acc={res.final_acc:.4f} upload_vs_dense(paper)="
              f"{up['upload_vs_dense']:.6f}", flush=True)
        if label == "off":
            check(priv is None, "the off arm has a privacy block")
            off_sim, off_res = sim, res
        else:
            check(round(eps, 1) == want_eps[label],
                  f"{label} eps {eps:.4f} != {want_eps[label]}")
    inert = Simulation(arms["off"].replace(out_json=None, dp=DPConfig()),
                       device="cuda")
    inert_res = inert.run()
    same = (inert_res.ledger.summary() == off_res.ledger.summary()
            and all(bits_equal(inert.state.params[n], off_sim.state.params[n])
                    for n in off_sim.state.params))
    print(f"[dp] off arm vs the same run with an inactive DPConfig() "
          f"(clip=inf, sigma=0): parameters and ledger bit-identical={same}",
          flush=True)
    check(same, "an inactive DPConfig changed the off arm")


# --------------------------------------------------------- phase 8: tree
TREE_SURVIVORS = [5, 6, 4, 4, 4, 5, 5, 5]      # the reference's tree_quick
REF_ACC = {"tree_quick": 0.941, "async_quick": 0.938}
ACC_TOL = 0.02     # card vs the port's CPU run (f32 sums in another order)


def flat_of(info, sa) -> "object":
    """The flat decode of the streams a tree round decoded (same survivors,
    same recovery seeds), on the card."""
    from repro_torch.core import streams as se

    size = info["size"]
    dropped = bool(info.get("dropped"))
    return se.decode_leaf_batch(
        info["streams"], nb=1, m=size, size=size,
        alive=info["alive"] if dropped else None,
        pair_seeds=info["recovery_seeds"] if dropped else None,
        pair_signs=info["pair_signs"] if dropped else None,
        k_mask=info["k_mask"], mask_p=sa.p, mask_q=sa.q,
        leaf_id=info["leaf_id"])


def tree_phase(kind: str) -> dict:
    """tree_quick on the card (tree == flat on every leaf of every round),
    then 2 VGG16 rounds under the tree protocol."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get("tree_quick").replace(out_json=None)
    sim = Simulation(cfg, device="cuda")
    n_leaves = len(sim.model.leaf_names())
    kept = []

    def keep(leaf_id, name, info):
        kept.append(dict(clone_info(info), leaf_id=leaf_id))

    sim.leaf_hook = keep
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    counts = ops.launch_counts()
    same = all(bits_equal(k["dense"], flat_of(k, cfg.sa)) for k in kept)
    del kept
    cpu = Simulation(cfg, device="cpu").run()
    tp = res.ledger.totals("paper")
    surv = [e.n_survivors for e in res.ledger.entries]
    dropout_rounds = sum(s < cfg.clients_per_round for s in surv)
    print(f"[tree] tree_quick on {kind}: groups={cfg.tree_groups} "
          f"survivors={surv} launches={counts} upload_vs_dense(paper)="
          f"{tp['upload_vs_dense']:.6f} (total "
          f"{tp['total_upload_vs_dense']:.6f}, tpu "
          f"{res.ledger.totals('tpu')['upload_vs_dense']:.6f}) "
          f"final_acc={res.final_acc:.4f} (the port on the CPU "
          f"{cpu.final_acc:.4f}, the reference {REF_ACC['tree_quick']}) "
          f"accs={res.accuracies} wall_s={res.wall_s:.4f}", flush=True)
    print(f"[tree] every leaf of every round: tree decode bit-equal to the "
          f"flat decode of the same streams on the card={same} "
          f"({n_leaves} leaves x {cfg.rounds} rounds)", flush=True)
    check(same, "a tree decode differs from the flat decode")
    check(surv == TREE_SURVIVORS, f"survivors {surv} != {TREE_SURVIVORS}")
    check(abs(tp["upload_vs_dense"] - 0.063) <= 0.005,
          f"tree_quick upload {tp['upload_vs_dense']:.4f} outside 6.3% +- 0.5")
    check(abs(res.final_acc - cpu.final_acc) <= ACC_TOL,
          f"tree_quick accuracy {res.final_acc:.4f} vs the CPU's "
          f"{cpu.final_acc:.4f}")
    check(abs(res.final_acc - REF_ACC["tree_quick"]) <= ACC_TOL,
          f"tree_quick accuracy {res.final_acc:.4f} vs the reference's")
    check(counts["stream_scatter_add"] == 3 * n_leaves * cfg.rounds,
          f"tree_quick launched the scatter {counts['stream_scatter_add']} "
          f"times, expected 3 groups x {n_leaves} leaves x {cfg.rounds}")
    check(counts["pair_mask_streams"] == cfg.rounds + dropout_rounds,
          f"tree_quick launched the masks {counts['pair_mask_streams']} "
          f"times, expected {cfg.rounds} + {dropout_rounds} (one a round, "
          f"one more a dropout round)")

    # VGG16 under the tree protocol: full-size _scatter_range launches, and
    # the largest leaf also decoded over an uneven split
    cfg = vgg16_table2().replace(name="table2_vgg16_tree", topology="tree",
                                 tree_groups=3)
    sim = Simulation(cfg, device="cuda")
    checked, probe = [0, 0], {}

    def compare(leaf_id, name, info):
        before = ops.launch_counts()
        ok = bits_equal(info["dense"], flat_of(dict(info, leaf_id=leaf_id),
                                               cfg.sa))
        size = info["size"]
        if size == 2359296 and ok:
            uneven = (0, 1, 1_000_003, 1_999_999, size)
            ok = bits_equal(info["dense"], se.decode_leaf_tree(
                info["streams"], nb=1, m=size, size=size, splits=uneven,
                k_mask=info["k_mask"], leaf_id=leaf_id))
            checked[1] += 1
        after = ops.launch_counts()
        for k in after:
            probe[k] = probe.get(k, 0) + after[k] - before[k]
        check(ok, f"VGG16 tree decode differs from flat at {name}")
        checked[0] += 1

    sim.leaf_hook = compare
    ops.reset_launch_counts()
    res = sim.run()
    counts = {k: v - probe.get(k, 0) for k, v in ops.launch_counts().items()}
    finite = all(torch.isfinite(p).all() for p in sim.state.params.values())
    print(f"[tree] cifar_vgg16 table2 protocol, topology=tree groups=3: "
          f"rounds={cfg.rounds} launches={counts} (comparisons excluded) "
          f"leaves checked={checked[0]} (tree == flat, bit-equal; "
          f"{checked[1]} 2,359,296-element leaves also over the uneven "
          f"split (0, 1, 1000003, 1999999, 2359296)) wall_s="
          f"{res.wall_s:.4f} upload_vs_dense(paper)="
          f"{res.ledger.totals('paper')['upload_vs_dense']:.6f} "
          f"finite={finite}", flush=True)
    check(finite, "non-finite VGG16 parameters under the tree protocol")
    check(checked[1] > 0, "no 2,359,296-element leaf was checked")
    check(counts["stream_scatter_add"] == 3 * checked[0],
          f"VGG16 tree launched the scatter {counts['stream_scatter_add']} "
          f"times for {checked[0]} leaf decodes")
    return counts


# -------------------------------------------------------- phase 9: async
ASYNC_STALENESS = [[0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 3, 0],
                   [3, 3, 1, 2], [1, 0, 0, 2], [2, 0, 1, 1], [2, 3, 2, 3]]


def async_phase(kind: str) -> None:
    """async_quick on the card, then an all-fresh buffer against the
    synchronous round."""
    import torch

    from repro_torch.core import fedavg
    from repro_torch.core.types import SecureAggConfig
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import AsyncSimulation

    cfg = presets.get("async_quick").replace(out_json=None)
    sim = AsyncSimulation(cfg, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    counts = ops.launch_counts()
    cpu = AsyncSimulation(cfg, device="cpu").run()
    taus = [list(e.staleness) for e in res.ledger.entries]
    tp = res.ledger.totals("paper")
    print(f"[async] async_quick on {kind}: buffer={sim.buffer} "
          f"max_staleness={cfg.max_staleness} staleness={taus} "
          f"launches={counts} upload_vs_dense(paper)="
          f"{tp['upload_vs_dense']:.6f} (tpu "
          f"{res.ledger.totals('tpu')['upload_vs_dense']:.6f}) "
          f"final_acc={res.final_acc:.4f} (the port on the CPU "
          f"{cpu.final_acc:.4f}, the reference {REF_ACC['async_quick']}) "
          f"accs={res.accuracies} wall_s={res.wall_s:.4f}", flush=True)
    check(taus == ASYNC_STALENESS, f"staleness {taus}")
    check(abs(tp["upload_vs_dense"] - 0.070) <= 0.005,
          f"async_quick upload {tp['upload_vs_dense']:.4f} outside "
          "7.0% +- 0.5")
    check(abs(res.final_acc - cpu.final_acc) <= ACC_TOL,
          f"async_quick accuracy {res.final_acc:.4f} vs the CPU's "
          f"{cpu.final_acc:.4f}")
    check(abs(res.final_acc - REF_ACC["async_quick"]) <= 1.5 * ACC_TOL,
          f"async_quick accuracy {res.final_acc:.4f} vs the reference's")
    n_leaves = len(sim.model.leaf_names())
    check(counts["stream_scatter_add"] == n_leaves * cfg.rounds,
          f"async_quick launched the scatter {counts['stream_scatter_add']} "
          "times")

    # an all-fresh buffer (every tau 0) is the synchronous round, bit for bit
    state = sim._fresh_state()
    cohort = sim.sampler.cohort_for(0)
    batches = sim._batches_for(0, cohort)
    params = state.params
    a = fedavg.run_async_update(
        fedavg.init_state(params, sim.fed), batches,
        {c: params for c in batches}, sim.loss_fn, sim.fed, cfg.thgs)
    b = fedavg.run_round(fedavg.init_state(params, sim.fed), batches,
                         sim.loss_fn, sim.fed, cfg.thgs,
                         SecureAggConfig(enabled=False))
    same = (all(bits_equal(a.params[n], b.params[n]) for n in params)
            and all(bits_equal(a.residuals[c][n], b.residuals[c][n])
                    for c in batches for n in params)
            and a.losses == b.losses)
    print(f"[async] all-fresh buffer {sorted(batches)} through "
          f"run_async_update vs run_round on {kind}: parameters, residuals "
          f"and losses bit-equal={same}", flush=True)
    check(same, "an all-fresh async buffer differs from the sync round")


# ------------------------------------------------------------------ phase 8
# (tag, B, T, S, Hq, Hkv, hd, dtype, causal, window, needle). The first two
# are timed beside the bound, the plain version and SDPA; the f32 rows (the
# CUDA-core instance) get a raw-launch time too. A needle is a key of V set to 1000.0
# that the rows it names must not see: an int is a key position (the rows
# before it under causal, the rows past its window), "pad" fills the memory
# past S of a B = 1 view with it (no row may read past S). A mask or
# descriptor fault then errs by hundreds.
FLASH_SHAPES = (
    ("yi_6b.prefill", 4, 1024, 1024, 32, 4, 128, "bfloat16", True, None,
     None),
    ("yi_6b.long", 1, 4096, 4096, 32, 4, 128, "bfloat16", True, None, None),
    ("f32", 2, 256, 256, 8, 2, 64, "float32", True, None, None),
    ("tail24", 2, 24, 24, 32, 4, 128, "bfloat16", True, None, None),
    ("tail1000", 1, 1000, 1000, 8, 2, 64, "float32", True, None, None),
    ("mqa", 2, 512, 512, 32, 1, 128, "bfloat16", True, None, None),
    ("window256", 1, 1000, 1000, 32, 4, 128, "bfloat16", True, 256, None),
    ("hd64", 2, 512, 512, 8, 2, 64, "bfloat16", True, None, None),
    ("noncausal", 2, 384, 384, 8, 2, 128, "bfloat16", False, None, None),
    ("t_gt_s", 1, 100, 40, 4, 2, 64, "bfloat16", True, 8, None),
    ("ragged", 2, 333, 333, 8, 2, 128, "bfloat16", True, None, None),
    ("ragged.t_ne_s", 1, 700, 333, 8, 2, 128, "bfloat16", False, None,
     None),
    ("window256.hd64", 1, 700, 700, 8, 2, 64, "bfloat16", False, 256, None),
    ("needle.causal", 1, 256, 256, 8, 2, 128, "bfloat16", True, None, 200),
    ("needle.window", 1, 1000, 1000, 8, 2, 128, "bfloat16", True, 256, 300),
    ("needle.pad", 1, 300, 300, 8, 2, 64, "bfloat16", False, None, "pad"),
    # the families' other prefill shapes (phase 16): Llama-3.2-Vision's
    # cross-attention over 1,024 image tokens and its self layers,
    # DeepSeek-MoE's and Llama-4-Scout's self layers
    ("vlm.cross", 2, 1024, 1024, 64, 8, 128, "bfloat16", False, None, None),
    ("vlm.self", 2, 1024, 1024, 64, 8, 128, "bfloat16", True, None, None),
    ("deepseek.self", 4, 1024, 1024, 16, 16, 128, "bfloat16", True, None,
     None),
    ("llama4.self", 4, 1024, 1024, 40, 8, 128, "bfloat16", True, None, None),
    # head widths 80 (HuBERT-XLarge, 1280 / 16) and 112 (Zamba2-7B's shared
    # block, 3584 / 32): P V on the tensor cores at the width padded to 128
    ("hubert.encode", 4, 1024, 1024, 16, 16, 80, "bfloat16", False, None,
     None),
    ("zamba2.shared", 4, 1024, 1024, 32, 32, 112, "bfloat16", True, None,
     None),
    ("f32.hd80", 2, 256, 256, 8, 8, 80, "float32", False, None, None),
    ("f32.hd112", 2, 256, 256, 8, 8, 112, "float32", True, None, None),
    ("tail24.hd80", 2, 24, 24, 16, 16, 80, "bfloat16", False, None, None),
    ("ragged.hd112", 1, 333, 333, 32, 32, 112, "bfloat16", True, None, None),
    ("tail1000.hd80.f32", 1, 1000, 1000, 4, 4, 80, "float32", False, None,
     None),
    ("tail1000.hd112.f32", 1, 1000, 1000, 4, 4, 112, "float32", True, None,
     None),
    ("needle.causal.hd112", 1, 256, 256, 8, 8, 112, "bfloat16", True, None,
     200),
    ("needle.window.hd80", 1, 1000, 1000, 8, 8, 80, "bfloat16", True, 256,
     300),
    ("needle.pad.hd80", 1, 300, 300, 8, 8, 80, "bfloat16", False, None,
     "pad"),
    ("needle.pad.hd112", 1, 300, 300, 8, 8, 112, "bfloat16", True, None,
     "pad"),
)
# rows timed beside the bound and SDPA (with the f32 rows, timed beside
# their bound): the first is the kernel's main row in the report
FLASH_TIMED = ("yi_6b.prefill", "yi_6b.long", "hubert.encode",
               "zamba2.shared")
NEEDLE = 1000.0


def visible_pairs(T: int, S: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask keeps: the score and P V work."""
    n = 0
    for q in range(T):
        hi = min(q, S - 1) if causal else S - 1
        lo = max(0, q - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def flash_inputs(B, T, S, H, Hkv, hd, dtype, causal, window, needle,
                 seed: int, device):
    """q, k, v from a seed, with the needle placed; and the rows that must
    not see it (None: no needle)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    pad = 128 if needle == "pad" else 0
    q = torch.randn((B, T, H, hd), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((B, S + pad, Hkv, hd), generator=gen,
                        device=device).to(dtype) for _ in range(2))
    if needle is None:
        return q, k, v, None
    if needle == "pad":
        k[:, S:] = 30.0              # large scores, were the pad ever read
        v[:, S:] = NEEDLE
        k, v = k[:, :S], v[:, :S]    # B = 1: a prefix, so no copy is made
        return q, k, v, torch.ones(T, dtype=torch.bool, device=device)
    v[:, needle] = NEEDLE
    pos = torch.arange(T, device=device)
    blind = torch.zeros(T, dtype=torch.bool, device=device)
    if causal:
        blind |= needle > pos
    if window is not None:
        blind |= needle <= pos - window
    return q, k, v, blind


def flash_phase(device, require_hgmma: bool = True) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build, flash_attention as flash, ref

    # the bf16 instances run on the tensor cores: count the HGMMA
    # instructions in the built library
    lib = build._lib_path("flash_attention.cu")
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"no cuobjdump beside nvcc ({cuobjdump})")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"[flash] {lib.name}: {hgmma} HGMMA instructions in its SASS "
          "(cuobjdump -sass)", flush=True)
    check(hgmma > 0 or not require_hgmma,
          "the flash library has no HGMMA instruction")

    rows = []
    for i, (tag, B, T, S, H, Hkv, hd, dt, causal, window, needle) in (
            enumerate(FLASH_SHAPES)):
        dtype = getattr(torch, dt)
        q, k, v, blind = flash_inputs(B, T, S, H, Hkv, hd, dtype, causal,
                                      window, needle, 100 + i, device)
        out = flash.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        rel = err / plain.float().abs().max().item()
        check(out.dtype == dtype and out.shape == q.shape
              and torch.allclose(out.float(), plain.float(), rtol=tol,
                                 atol=tol),
              f"flash_attention != plain at {tag} (max abs {err:.3e}, "
              f"tolerance {tol})")
        row = dict(shape=tag, B=B, T=T, S=S, H=H, Hkv=Hkv, hd=hd, dtype=dt,
                   causal=causal, window=window, max_abs_err=err,
                   rel_err=rel)
        line = (f"[flash] {tag}: B={B} T={T} S={S} H={H} Hkv={Hkv} hd={hd} "
                f"{dt} causal={causal} window={window} max_abs_err={err:.3e} "
                f"rel_err={rel:.3e} (tolerance {tol})")
        if blind is not None:
            n_blind = int(blind.sum())
            check(n_blind > 0, f"{tag}: no row is blind to the needle")
            blind_err = diff[:, blind].max().item()
            blind_max = plain.float()[:, blind].abs().max().item()
            row.update(needle=needle, blind_rows=n_blind,
                       blind_max_abs_err=blind_err)
            line += (f" needle={needle}: {n_blind} rows blind to it, their "
                     f"max_abs_err={blind_err:.3e} (max |plain| "
                     f"{blind_max:.3f})")
            check(blind_err <= tol * (1 + blind_max),
                  f"{tag}: rows blind to the needle err by {blind_err:.3e}")
        if tag in FLASH_TIMED or dtype == torch.float32:
            fn = build.kernel("flash_attention")
            o = torch.empty_like(q)

            def launch():
                build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), B, T, S, H, Hkv, hd, int(causal),
                               window or 0, build.DTYPE_CODES[dtype],
                               torch.cuda.current_stream().cuda_stream),
                            "flash_attention")

            ms = graph_ms(launch, reps=5, inner=10)
            # 4 hd flops (two products) for each pair the mask keeps, at the
            # true head width
            flops = 4 * B * H * hd * visible_pairs(T, S, causal, window)
            nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
            rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
            bound_ms, bound_by = bound(nbytes, flops, rate)
            row.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                       flops=flops, bytes=nbytes)
            line += (f" ms={ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}: "
                     f"{flops:.4g} flops, {nbytes / 1e6:.1f} MB) "
                     f"TFLOP/s={flops / ms / 1e9:.2f}")
        if tag in FLASH_TIMED:
            check(window is None and T == S, f"{tag}: SDPA takes no window")
            plain_ms = events_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal), reps=3, inner=2)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            lib_err = (lib_out.transpose(1, 2).float() - plain.float()
                       ).abs().max().item()
            lib_ms = events_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), reps=5,
                inner=10)
            row.update(plain_ms=plain_ms, library_ms=lib_ms)
            line += (f" plain_ms={plain_ms:.6f} sdpa_ms={lib_ms:.6f} (sdpa "
                     f"vs plain {lib_err:.3e}) vs_bound="
                     f"{ms / bound_ms:.2f}x vs_sdpa={ms / lib_ms:.2f}x")
        rows.append(row)
        print(line, flush=True)
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 9
LM_TOL = 2e-4      # f32 logits, card vs CPU: sum order over d_model 4096


def lm_phase(kind: str, card: str, flash_main_ms: float) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, serving
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import transformer as tf

    cfg = configs.get("yi_6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype}: {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(n_params == 6_061_035_520, f"Yi-6B has {n_params} parameters")
    B, T, n_new = 4, 1024, 16
    prompts, _ = make_lm_tokens(cfg.vocab, 8, T, seed=1)
    prompts = np.asarray(prompts, np.int32)
    adapter = serving.LMAdapter(cfg, max_batch=B, prompt_len=T, n_new=n_new)
    # warm-up batch (cuBLAS handles, allocator) outside the counted run
    warm = serving.InferenceServer(adapter, params)
    ticket = warm.submit(prompts[0])
    warm.step()
    ticket.wait(0)

    metrics = serving.ServingMetrics(offered_qps=100.0)
    server = serving.InferenceServer(adapter, params, metrics=metrics)
    loadgen = serving.LoadGenerator(server, prompts, 100.0, metrics=metrics,
                                    wait_timeout_s=300.0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    server.start()
    try:
        loadgen.run(n_requests=len(prompts))
        tickets = list(loadgen._tickets)
        errors = loadgen.drain()
    finally:
        server.stop()
    counts = ops.launch_counts()
    doc = metrics.summary()
    outs = [t.wait(0) for t in tickets]
    prefills = doc["batches"]["count"]
    lat = doc["latency_us"]
    print(f"[lm] served {doc['requests']} in {prefills} batches (fills "
          f"{metrics.batch_fills}) launches={counts} tokens="
          f"{doc['tokens']['generated']} tok_s={doc['tokens']['tok_s']:.2f} "
          f"wall_s={doc['wall_s']:.4f} latency p50={lat['p50'] / 1e3:.1f} ms "
          f"p99={lat['p99'] / 1e3:.1f} ms", flush=True)
    print(f"[lm] first response: {list(map(int, outs[0]))}", flush=True)
    check(errors == 0 and doc["requests"] == {"submitted": 8, "served": 8,
                                              "errors": 0},
          f"served {doc['requests']} with {errors} errors")
    check(all(o.shape == (n_new,) and o.dtype == np.int32
              and int(o.min()) >= 0 and int(o.max()) < cfg.vocab
              for o in outs), "a response is not 16 tokens in the vocabulary")
    check(counts["flash_attention"] == cfg.n_layers * prefills,
          f"flash_attention launched {counts['flash_attention']} times for "
          f"{prefills} prefills of {cfg.n_layers} layers")
    errs = serving.validate_metrics(doc)
    check(not errs, f"invalid repro.serve/v1 document: {errs}")

    # prefill and decode times at the served shape, synchronous
    tokens = torch.from_numpy(prompts[:B]).cuda()
    cache_len = adapter.cache_len
    times = {"prefill": [], "decode": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = tf.prefill(params, cfg, tokens, cache_len)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t0)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(n_new - 1):
            logits, state = tf.decode_step(params, cfg, tok, state)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        times["decode"].append((time.perf_counter() - t0) / (n_new - 1))
    prefill_ms = statistics.median(times["prefill"]) * 1e3
    decode_ms = statistics.median(times["decode"]) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    share = cfg.n_layers * flash_main_ms / prefill_ms
    print(f"[lm] {card}: prefill B={B} T={T} {prefill_ms:.3f} ms "
          f"({B * T / prefill_ms * 1e3:.0f} tok/s), decode "
          f"{decode_ms:.3f} ms a token step at B={B} "
          f"({B / decode_ms * 1e3:.1f} tok/s), served "
          f"{doc['tokens']['tok_s']:.2f} tok/s, peak memory "
          f"{peak_gib:.2f} GiB, flash kernel {cfg.n_layers} x "
          f"{flash_main_ms:.4f} ms = {share:.1%} of a prefill", flush=True)
    # where a prefill's and a decode step's time goes: kernel launches and
    # device time (one stream: kernels do not overlap) against the wall
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for what, fn in (
            ("prefill", lambda: tf.prefill(params, cfg, tokens, cache_len)),
            ("decode step", lambda: tf.decode_step(params, cfg, tok, state))):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
               for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))]
        dev = [d for d in dev if d[2] > 0]
        dev_ms = sum(d[2] for d in dev) / 1e3
        flash_ms = sum(d[2] for d in dev if "flash_attention" in d[0]) / 1e3
        top = sorted(dev, key=lambda d: -d[2])[:4]
        print(f"[lm] profiled {what}: wall {wall_ms:.3f} ms, "
              f"{sum(d[1] for d in dev)} kernel launches, device "
              f"{dev_ms:.3f} ms (busy {dev_ms / wall_ms:.1%}), flash "
              f"{flash_ms:.3f} ms; top: " + "; ".join(
                  f"{k[:48]} x{c} {t / 1e3:.3f} ms" for k, c, t in top),
              flush=True)
    del params, state, logits
    torch.cuda.empty_cache()

    # parity at full width, reduced depth: the card against the CPU
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_model = tf.init_params(small,
                                torch.Generator(device="cuda").manual_seed(0))
    cpu_model = tf.init_params(small, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    prompt, _ = make_lm_tokens(cfg.vocab, 1, 256, seed=2)
    prompt = torch.from_numpy(np.asarray(prompt, np.int32))
    ops.reset_launch_counts()
    lc, _ = tf.prefill(card_model, small, prompt.cuda(), 264)
    check(ops.launch_counts()["flash_attention"] == 2,
          "the parity prefill did not run the flash kernel")
    lp, _ = tf.prefill(cpu_model, small, prompt, 264)
    err = (lc.cpu() - lp).abs().max().item()
    gc = greedy_generate(card_model, small, prompt.cuda(), 4, 264).cpu()
    gp = greedy_generate(cpu_model, small, prompt, 4, 264)
    print(f"[lm] parity {cfg.name} full width, 2 layers, f32 (TF32 off), "
          f"prompt 256: prefill logits card vs CPU max abs err {err:.3e} "
          f"(max |logit| {lp.abs().max().item():.3f}, tolerance {LM_TOL}); "
          f"greedy tokens card {gc.tolist()} CPU {gp.tolist()}", flush=True)
    check(err <= LM_TOL, f"card vs CPU logits differ by {err:.3e}")
    check(torch.equal(gc, gp), "card and CPU greedy tokens differ")
    del card_model, cpu_model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------- phase 16: families
# (arch, layers on the card or None for all, batch): full width, random
# bf16 weights drawn on the card from seed 0, one config at a time
FAMILY_CELLS = (("deepseek_moe_16b", 8, 4), ("llama4_scout_17b_a16e", 2, 4),
                ("llama32_vision_90b", 10, 2), ("zamba2_7b", None, 4),
                ("xlstm_125m", None, 4), ("hubert_xlarge", None, 4))
FAMILY_T = 1024          # prompt tokens (audio: frames; VLM: image tokens)
FAMILY_NEW = 16          # greedy tokens
# the reference's contract (tests/test_models_smoke.py): forward over T + 1
# tokens against prefill(T) + one decode step, last-position logits, in
# bf16: |diff| <= 2^-4 * max(1, max |logit|) (a few bf16 ulps of a logit:
# the two paths round their products and the residual stream to bf16 at
# different shapes, and the decode's attention keeps bf16 scores)
FAMILY_TOL = 2.0 ** -4
MOE_F32_RTOL, MOE_F32_ATOL = 2e-2, 2e-3   # the reference test's allclose
# one MoE layer in f32 at the configured capacity, card vs CPU: the largest
# |y| gap (sum order of the expert and shared products), 4x the larger
# reading (9.775e-06 DeepSeek-MoE, 1.347e-05 Llama-4-Scout; max |y| 3.4-3.8)
MOE_CAP_ATOL = 5.4e-5


def profiled(fn) -> dict:
    """Wall ms, CUDA kernel launches and device ms of one call of fn
    (``torch.profiler``, device activity only: the host's op events would
    cost a long trace on a prefill of 100,000+ launches; one stream, so
    kernels do not overlap)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
           for e in prof.key_averages()
           if "CUDA" in str(getattr(e, "device_type", ""))]
    dev = [d for d in dev if d[2] > 0]
    dev_ms = sum(d[2] for d in dev) / 1e3
    top = sorted(dev, key=lambda d: -d[2])[:3]
    return {"wall_ms": wall_ms, "kernels": sum(d[1] for d in dev),
            "device_ms": dev_ms, "busy": dev_ms / wall_ms,
            "flash_ms": sum(d[2] for d in dev
                            if "flash_attention" in d[0]) / 1e3,
            "top": [(k[:48], c, t / 1e3) for k, c, t in top]}


@contextlib.contextmanager
def first_calls(flash_seen: dict, moe_seen: list):
    """Within the block, keep the first flash call of each shape (its inputs
    and the kernel's output) and the last MoE layer's (params, input): held
    against the plain version and the CPU after the counted prefill. The
    clones launch no counted kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod

    flash0, moe0 = ops.flash_attention, moe_mod.apply_moe

    def flash_hook(q, k, v, *, causal=True, window=None):
        out = flash0(q, k, v, causal=causal, window=window)
        key = (tuple(q.shape), tuple(k.shape), causal, window)
        if key not in flash_seen:
            flash_seen[key] = (q.clone(), k.clone(), v.clone(), out.clone())
        return out

    def moe_hook(p, x, spec):
        moe_seen[:] = [(p, x.clone())]
        return moe0(p, x, spec)

    ops.flash_attention, moe_mod.apply_moe = flash_hook, moe_hook
    try:
        yield
    finally:
        ops.flash_attention, moe_mod.apply_moe = flash0, moe0


def flash_calls_check(arch: str, flash_seen: dict) -> str:
    """Each kept flash call of a prefill against the plain version on the
    same card tensors, at the bf16 tolerance of phase 10."""
    import torch

    from repro_torch.kernels import ref

    tol, parts = 2e-2, []
    for (qs, ks, causal, window), (q, k, v, out) in flash_seen.items():
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = (out.float() - plain.float()).abs().max().item()
        check(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol),
              f"{arch}: flash at q {qs} k {ks} causal={causal} != plain "
              f"(max abs {err:.3e}, tolerance {tol})")
        parts.append(f"q {list(qs)} k {list(ks)} causal={causal} "
                     f"{err:.3e}")
    return "; ".join(parts)


def moe_capacity_check(arch: str, spec, p, x) -> str:
    """One MoE layer at the configured capacity in f32 (TF32 off), on the
    card and on the same inputs on the CPU: the chosen experts and the
    dispatch slots (so the dropped set) equal, some token dropped, y within
    MOE_CAP_ATOL."""
    import torch

    from repro_torch.models import moe as moe_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    e, k = spec.n_experts, spec.top_k
    cap = moe_mod.capacity(x.shape[1], spec)
    got = {}
    for dev in ("cuda", "cpu"):
        pd = {n: t.detach().to(dev, torch.float32) for n, t in p.items()}
        xd = x.to(dev, torch.float32)
        _, eidx = moe_mod.route(torch.softmax(xd @ pd["router"], -1), k)
        _, slot, _ = moe_mod._dispatch(xd, eidx, e, k, cap)
        y = moe_mod.apply_moe(pd, xd, spec).y
        got[dev] = (eidx.cpu(), slot.cpu(), y.cpu())
        del pd, xd
    (e_c, s_c, y_c), (e_h, s_h, y_h) = got["cuda"], got["cpu"]
    dropped = int((s_h == e * cap).sum())
    check(torch.equal(e_c, e_h), f"{arch}: MoE experts differ, card vs CPU")
    check(torch.equal(s_c, s_h), f"{arch}: MoE dispatch slots differ, card "
          "vs CPU")
    check(dropped > 0, f"{arch}: no token dropped at capacity {cap}: the "
          "check's precondition")
    err = (y_c - y_h).abs().max().item()
    check(err <= MOE_CAP_ATOL, f"{arch}: MoE y card vs CPU {err:.3e} "
          f"(limit {MOE_CAP_ATOL})")
    return (f"MoE layer f32 at capacity {cap} ({spec.capacity_factor}), card "
            f"vs CPU: experts and slots equal, {dropped} of {s_h.numel()} "
            f"assignments dropped, y max abs err {err:.3e} (max |y| "
            f"{y_h.abs().max().item():.3f}, limit {MOE_CAP_ATOL})")


def attention_layers(cfg) -> int:
    """Flash launches one prefill makes: one per self- or cross-attention
    layer call (the hybrid's shared block once a super-block)."""
    from repro_torch.models import transformer as tf

    if cfg.xlstm:
        return 0
    if cfg.family == "hybrid":
        return tf.n_super(cfg)
    return cfg.n_layers


def family_cell(arch: str, layers, B: int, card: str) -> int:
    """One config through the checks and timings of phase 16; returns the
    flash launches of its first prefill."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import next_token
    from repro_torch.models import transformer as tf

    full = configs.get(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    T = FAMILY_T
    torch.cuda.reset_peak_memory_stats()
    t_cell = t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    draw_s = time.perf_counter() - t0
    audio = cfg.family == "audio"
    img = None
    if audio:      # frame embeddings [B, T, d], the encoder's input
        inp = torch.randn((B, T + 1, cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16)
    else:
        toks, _ = make_lm_tokens(cfg.vocab, B, T + 1, seed=1)
        inp = torch.from_numpy(np.asarray(toks, np.int32)).cuda()
    if cfg.family == "vlm":
        img = torch.randn((B, cfg.n_image_tokens, cfg.d_model),
                          generator=gen, device="cuda").to(torch.bfloat16)
    prompt, last = inp[:, :T], inp[:, T:T + 1]
    cache_len = T + FAMILY_NEW + 8

    def run_prefill():
        return tf.prefill(params, cfg, prompt, cache_len, image_embeds=img)

    # counts reset just before the first prefill, read just after it
    flash_seen, moe_seen = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with first_calls(flash_seen, moe_seen):
        logits0, _ = run_prefill()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    flash_line = flash_calls_check(arch, flash_seen)
    del flash_seen
    moe_line = ""
    if moe_seen:
        moe_line = "; " + moe_capacity_check(arch, cfg.moe, *moe_seen[0])
        del moe_seen
        torch.cuda.empty_cache()
    want = attention_layers(cfg)
    check(counts["flash_attention"] == want,
          f"{arch}: a prefill launched flash_attention "
          f"{counts['flash_attention']} times for {want} attention layers")
    times = []
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, state = run_prefill()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        outs.append(lg)
    prefill_ms = min(times)
    same = bits_equal(outs[0], outs[1]) and bits_equal(outs[0], logits0)
    check(same, f"{arch}: two prefills of one batch differ")
    finite = bool(torch.isfinite(logits0).all())
    check(finite and tuple(logits0.shape) == (B, 1, cfg.vocab),
          f"{arch}: prefill logits {tuple(logits0.shape)}, finite={finite}")

    decode_ms, tokens = None, None
    if audio:
        try:
            tf.decode_step(params, cfg, last, state)
            check(False, f"{arch}: the encoder took a decode step")
        except ValueError:
            pass
    else:
        tok = next_token(outs[1])
        gen_toks = [tok]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(FAMILY_NEW - 1):
            lg, state = tf.decode_step(params, cfg, tok, state)
            tok = next_token(lg)
            gen_toks.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t1) * 1e3 / (FAMILY_NEW - 1)
        tokens = torch.cat(gen_toks, 1).cpu()
        check(bool(torch.isfinite(lg).all())
              and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab,
              f"{arch}: decode logits not finite or tokens out of range")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    prof_prefill = profiled(run_prefill)
    prof_decode = None
    if not audio:
        _, st = run_prefill()
        tok = next_token(outs[1])
        prof_decode = profiled(lambda: tf.decode_step(params, cfg, tok, st))
        del st

    # the reference's contract: forward over T + 1 against prefill(T) + one
    # decode step, in bf16 within FAMILY_TOL (the encoder has no decode
    # step, and its prefill is forward's last position)
    def contract(c, p):
        emb = tf.embed_tokens(p, c, inp)
        h, _ = tf.forward(p, c, emb, image_embeds=img)
        want_l = h[:, -1:] @ tf.lm_head_weight(p, c)
        _, st = tf.prefill(p, c, prompt, cache_len, image_embeds=img)
        got, _ = tf.decode_step(p, c, last, st)
        return got.float(), want_l.float()

    del state, outs, logits0
    line = "none (encoder-only)"
    if not audio:
        got, want_l = contract(cfg, params)
        err = (got - want_l).abs().max().item()
        scale = want_l.abs().max().item()
        tol = FAMILY_TOL * max(1.0, scale)
        line = (f"max abs err {err:.3e} (max |logit| {scale:.3f}, "
                f"tolerance {tol:.3e})")
    if cfg.family == "moe":
        # capacity drops differ between T and T + 1 tokens, and in bf16 a
        # last-token expert choice flips on a bf16 ulp of the router input
        # (top-k is not continuous). So MoE holds the contract as the
        # reference's own test does: no token dropped (capacity_factor
        # E / top_k: capacity >= T), in f32 (TF32 off) at full width, to
        # that test's allclose; the bf16 gap at the configured capacity is
        # printed, not held.
        wide32 = dataclasses.replace(cfg, dtype="float32", moe=(
            dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                / cfg.moe.top_k)))
        del params
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        params = tf.init_params(wide32, torch.Generator(
            device="cuda").manual_seed(0))
        g32, w32 = contract(wide32, params)
        err32 = (g32 - w32).abs().max().item()
        excess = ((g32 - w32).abs() - MOE_F32_RTOL * w32.abs()).max().item()
        check(excess <= MOE_F32_ATOL,
              f"{arch}: f32 forward(T+1) vs prefill(T) + decode, no drop: "
              f"|diff| exceeds {MOE_F32_RTOL} |want| by {excess:.3e} "
              f"(atol {MOE_F32_ATOL})")
        line = (f"held in f32 with no drop: max abs err {err32:.3e}, "
                f"excess over {MOE_F32_RTOL} |want| {excess:.3e} (atol "
                f"{MOE_F32_ATOL}); bf16, not held: {err:.3e} at capacity "
                f"factor {cfg.moe.capacity_factor} (max |logit| "
                f"{scale:.3f})")
    elif not audio:
        check(err <= tol, f"{arch}: forward(T+1) vs prefill(T) + decode "
              f"differ by {err:.3e} (tolerance {tol:.3e})")

    what = "encode" if audio else "prefill"
    print(f"[families] {cfg.name} on {card}: {cfg.n_layers} of "
          f"{full.n_layers} layers at full width (d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.hd}), "
          f"{n_params} parameters ({n_params * 2 / 1e9:.2f} GB bf16) drawn "
          f"in {draw_s:.1f} s; B={B} T={T}: {what} {prefill_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in times]}), decode "
          + (f"{decode_ms:.3f} ms a step" if decode_ms is not None
             else "none (encoder-only: ValueError)")
          + f", flash launches a prefill {counts['flash_attention']}, "
          f"bit-equal prefills {same}, peak memory {peak_gib:.2f} GiB; "
          + "contract forward(T+1) vs prefill(T)+decode " + line
          + f"; flash calls vs plain: {flash_line or 'none'}" + moe_line,
          flush=True)
    print(f"[families] {cfg.name} profiled {what}: wall "
          f"{prof_prefill['wall_ms']:.3f} ms, {prof_prefill['kernels']} "
          f"kernels, device {prof_prefill['device_ms']:.3f} ms (busy "
          f"{prof_prefill['busy']:.1%}), flash "
          f"{prof_prefill['flash_ms']:.3f} ms; top: " + "; ".join(
              f"{k} x{c} {t:.3f} ms" for k, c, t in prof_prefill["top"])
          + ("" if prof_decode is None else
             f"; decode step: wall {prof_decode['wall_ms']:.3f} ms, "
             f"{prof_decode['kernels']} kernels, device "
             f"{prof_decode['device_ms']:.3f} ms (busy "
             f"{prof_decode['busy']:.1%})")
          + ("" if tokens is None else
             f"; greedy tokens row 0 {tokens[0].tolist()}")
          + f"; the cell took {time.perf_counter() - t_cell:.1f} s",
          flush=True)
    del params, inp, img
    return counts["flash_attention"]


def families_phase(card: str) -> dict:
    """Every LM family at full width through init_params -> prefill ->
    decode_step on the card; returns the flash launches of the cells'
    first prefills."""
    import torch

    t0 = time.perf_counter()
    total = {"flash_attention": 0}
    for arch, layers, B in FAMILY_CELLS:
        total["flash_attention"] += family_cell(arch, layers, B, card)
        gc.collect()                 # free one config before the next
        torch.cuda.empty_cache()
    print(f"[families] phase 16 took {time.perf_counter() - t0:.1f} s on "
          f"{card}; flash launches {total['flash_attention']} over "
          f"{len(FAMILY_CELLS)} first prefills", flush=True)
    return total


# ----------------------------------------------------- phase 12: resume
RESUME_CUTS = (("table2_quick", 6), ("async_quick", 4))   # (preset, kill at)
SMOKE_DIR = ROOT / "build" / "smoke"       # checkpoints, removed at the end


class Killed(Exception):
    """Raised by a round hook to kill a run after a given round."""


def vgg16_tree(device, n_clients: int = 10) -> dict:
    """VGG16's params (He-normal, seed 0) and ``n_clients`` residuals
    (seeded normals) on the card: the tree a checkpoint of a VGG16 run
    holds."""
    import torch

    from repro_torch.models.paper_models import build_model

    model = build_model("cifar_vgg16").init_(
        torch.Generator().manual_seed(0))
    params = {n: p.detach().to(device) for n, p in model.params().items()}
    g = torch.Generator(device=device).manual_seed(1)
    residuals = {c: {n: 1e-3 * torch.randn(p.shape, generator=g,
                                           device=device)
                     for n, p in params.items()} for c in range(n_clients)}
    return {"params": params, "residuals": residuals}


def resume_in_fresh_process(preset: str, kind: str, ckpt_dir: str,
                            kill_at: int, full_sim, full) -> None:
    """Resume a killed leg's checkpoints with ``python -m repro_torch.sim``
    in a new process (a crash resume always starts one; cuBLAS may choose
    again there) and hold its JSON ledger, accuracies, losses and its final
    checkpoint bit-equal to the uninterrupted run of this process."""
    from repro_torch import checkpoint

    out = os.path.join(ckpt_dir, "resumed.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim", "--preset", preset,
         "--ckpt-dir", ckpt_dir, "--ckpt-every", str(kill_at),
         "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    t1 = time.perf_counter()
    check(proc.returncode == 0,
          f"python -m repro_torch.sim resuming {preset} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        doc = json.load(f)
    want = json.loads(json.dumps(full.summary(), default=float))
    rounds = [int(ln.split()[1]) for ln in proc.stdout.splitlines()
              if ln.startswith("round ")]
    ledger_eq = doc["ledger"]["entries"] == want["ledger"]["entries"]
    accs_eq = doc["accuracies"] == want["accuracies"]
    losses_eq = doc["losses"] == want["losses"]
    like = full_sim._ckpt_tree(full_sim.state)
    back = checkpoint.restore(ckpt_dir, full.rounds, like=like)
    leaves_eq: list = []
    checkpoint.map_leaves(lambda w, b: leaves_eq.append(bits_equal(b, w)),
                          like, back)
    state_eq = bool(leaves_eq) and all(leaves_eq)
    print(f"[resume] {preset} on {kind}, resumed in a fresh process "
          f"(python -m repro_torch.sim --ckpt-dir, {t1 - t0:.1f} s, eval "
          f"rounds {rounds}): against the uninterrupted run: ledger entries "
          f"equal={ledger_eq} accuracies equal={accs_eq} losses equal="
          f"{losses_eq} final checkpoint ({len(leaves_eq)} leaves) "
          f"bit-equal={state_eq}", flush=True)
    check(bool(rounds) and rounds[0] > kill_at,
          f"{preset}: the fresh process evaluated rounds {rounds}; it did "
          f"not resume after round {kill_at}")
    check(checkpoint.latest_step(ckpt_dir) == full.rounds,
          f"{preset}: the fresh process saved no final checkpoint")
    check(ledger_eq and accs_eq and losses_eq,
          f"{preset}: the fresh-process resume's ledger, accuracies or "
          "losses differ from the uninterrupted run")
    check(state_eq, f"{preset}: the fresh-process resume's final params, "
          "residuals or ring differ from the uninterrupted run")


def vgg16_table2(rounds: int = 2):
    """cifar_vgg16 on cifar10 under the table2 protocol (the config of
    phase 5)."""
    from repro_torch.sim import presets

    return presets.get("table2").replace(
        name="table2_vgg16", model="cifar_vgg16", dataset="cifar10",
        rounds=rounds, eval_every=1, out_json=None)


def nondeterministic_cudnn() -> None:
    """Leave cuDNN as far from deterministic as PyTorch allows
    (``deterministic`` off, autotuning on), so that only the engine's own
    setting can make a conv run repeatable."""
    import torch

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True


def vgg16_sgd_times(kind: str, reps: int = 5) -> dict:
    """VGG16's local SGD (the table2 protocol's first round, 5 clients, one
    ``batched_client_update``) timed with and without deterministic cuDNN,
    in turns, on the host clock after ``synchronize`` (median of ``reps``
    each, after one warm-up call each); autotuning off in both."""
    import torch

    from repro_torch.core import fedavg

    params, batches, loss_fn, fed = round_inputs(vgg16_table2(), "cuda")
    b = torch.backends.cudnn
    old = (b.deterministic, b.benchmark)
    ts = {True: [], False: []}
    deltas = {}
    try:
        for rep in range(reps + 1):
            for det in (True, False):
                b.deterministic, b.benchmark = det, False
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d, _ = fedavg.batched_client_update(
                    params, batches, loss_fn, fed.local_steps, fed.local_lr)
                torch.cuda.synchronize()
                if rep:
                    ts[det].append(time.perf_counter() - t0)
                deltas.setdefault(det, []).append(d)
    finally:
        b.deterministic, b.benchmark = old
    same = {det: all(bits_equal(x[n], deltas[det][0][n])
                     for x in deltas[det][1:] for n in x) for det in ts}
    ms = {det: 1e3 * statistics.median(ts[det]) for det in ts}
    print(f"[resume] cifar_vgg16 local SGD (5 clients x {fed.local_steps} "
          f"steps of {batches[0].shape[2]}) on {kind}: deterministic cuDNN "
          f"{ms[True]:.3f} ms, its {reps + 1} calls bit-equal={same[True]}; "
          f"without it {ms[False]:.3f} ms, bit-equal={same[False]} "
          f"(median of {reps}, in turns; ratio "
          f"{ms[True] / ms[False]:.3f})", flush=True)
    check(same[True], "VGG16's local SGD under deterministic cuDNN differs "
          "call to call")
    del deltas, params, batches
    torch.cuda.empty_cache()
    return ms


def vgg16_resume_leg(kind: str) -> None:
    """Two plain serial VGG16 engine runs (table2 protocol, 2 rounds), each
    started with cuDNN left non-deterministic, bit-equal: the engine sets
    deterministic cuDNN itself; then the run killed after round 1 and
    resumed, bit-equal to them; then its local SGD timed with and without
    deterministic cuDNN."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sim.engine import Simulation

    cfg = vgg16_table2()
    runs = []
    for _ in range(2):
        nondeterministic_cudnn()
        sim = Simulation(cfg, device="cuda")
        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        check(flags == (True, False), f"the engine left cuDNN at "
              f"deterministic={flags[0]} benchmark={flags[1]}")
        runs.append((sim, sim.run()))
    (a_sim, a), (b_sim, b) = runs
    two_eq = states_equal(a_sim.state, b_sim.state)
    same_log = (a.ledger.entries == b.ledger.entries
                and a.accuracies == b.accuracies and a.losses == b.losses)
    print(f"[resume] cifar_vgg16 table2 on {kind}: two serial runs, each "
          f"started with cuDNN non-deterministic and autotuning: params, "
          f"residuals bit-equal={two_eq}, ledger, accuracies, losses "
          f"equal={same_log} (losses {a.losses})", flush=True)
    check(two_eq == (True, True) and same_log,
          "two serial VGG16 runs of one config and seed differ")
    del runs, b_sim, b
    ckcfg = cfg.replace(ckpt_dir=str(SMOKE_DIR / "vgg16_run"), ckpt_every=1)

    def die(r, info):
        if r + 1 == 1:
            raise Killed

    nondeterministic_cudnn()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        Simulation(ckcfg, device="cuda").run(hooks=[die])
        fail("cifar_vgg16: the kill hook did not fire")
    except Killed:
        pass
    t1 = time.perf_counter()
    nondeterministic_cudnn()
    sim, seen = Simulation(ckcfg, device="cuda"), []
    res = sim.run(hooks=[lambda r, info: seen.append(r)])
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    eq = states_equal(sim.state, a_sim.state)
    same_log = (res.ledger.entries == a.ledger.entries
                and res.accuracies == a.accuracies and res.losses == a.losses)
    print(f"[resume] cifar_vgg16 table2 on {kind}: killed after round 1 "
          f"({t1 - t0:.3f} s, checkpoint included), resumed rounds "
          f"{[r + 1 for r in seen]} ({t2 - t1:.3f} s); against the "
          f"uninterrupted run: params, residuals bit-equal={eq}, ledger, "
          f"accuracies, losses equal={same_log}; launches over both legs="
          f"{counts}", flush=True)
    check(seen == [1], f"cifar_vgg16 resumed at the wrong round: {seen}")
    check(eq == (True, True) and same_log, "the resumed VGG16 run differs "
          "from the uninterrupted run")
    check(counts["pair_mask_streams"] == cfg.rounds,
          f"the VGG16 legs launched pair_mask_streams "
          f"{counts['pair_mask_streams']} times, expected one a round")
    del sim, a_sim, a, res
    torch.cuda.empty_cache()
    vgg16_sgd_times(kind)


def resume_phase(kind: str) -> dict:
    """Each of RESUME_CUTS killed by a hook after its round and resumed to
    the end, against an uninterrupted run in this process; then one VGG16
    checkpoint saved and restored. Returns the two legs' launch counts."""
    import shutil

    import torch

    from repro_torch import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import simulation_for

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    legs_counts = {}
    for preset, kill_at in RESUME_CUTS:
        cfg = presets.get(preset).replace(out_json=None)
        full_sim = simulation_for(cfg, device="cuda")
        full = full_sim.run()
        ckcfg = cfg.replace(ckpt_dir=str(SMOKE_DIR / preset),
                            ckpt_every=kill_at)

        def die(r, info, kill_at=kill_at):
            if r + 1 == kill_at:
                raise Killed

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            simulation_for(ckcfg, device="cuda").run(hooks=[die])
            fail(f"{preset}: the kill hook did not fire")
        except Killed:
            pass
        t1 = time.perf_counter()
        # a copy of the killed leg's checkpoints for the fresh-process resume
        shutil.copytree(ckcfg.ckpt_dir, ckcfg.ckpt_dir + "_cli")
        sim, seen = simulation_for(ckcfg, device="cuda"), []
        res = sim.run(hooks=[lambda r, info: seen.append(r)])
        t2 = time.perf_counter()
        counts = ops.launch_counts()
        legs_counts[preset] = counts
        a, b = sim.state, full_sim.state
        params_eq = all(bits_equal(a.params[n], b.params[n])
                        for n in b.params)
        resid_eq = (sorted(a.residuals) == sorted(b.residuals)
                    and all(bits_equal(a.residuals[c][n], b.residuals[c][n])
                            for c in b.residuals for n in b.params))
        ring_eq = (not hasattr(sim, "versions")
                   or (len(sim.versions) == len(full_sim.versions)
                       and all(bits_equal(v[n], w[n]) for v, w in
                               zip(sim.versions, full_sim.versions)
                               for n in w)))
        ledger_eq = res.ledger.entries == full.ledger.entries
        print(f"[resume] {preset} on {kind}: killed after round {kill_at} "
              f"({t1 - t0:.3f} s), resumed rounds {seen[0] + 1}-{seen[-1] + 1} "
              f"({t2 - t1:.3f} s); against the uninterrupted run: ledger "
              f"entries equal={ledger_eq} accuracies equal="
              f"{res.accuracies == full.accuracies} losses equal="
              f"{res.losses == full.losses} params bit-equal={params_eq} "
              f"residuals bit-equal={resid_eq} ring bit-equal={ring_eq} "
              f"launches over both legs={counts}", flush=True)
        check(seen == list(range(kill_at, cfg.rounds)),
              f"{preset} resumed at the wrong round: {seen}")
        check(ledger_eq and res.accuracies == full.accuracies
              and res.losses == full.losses,
              f"{preset}: the resumed run's ledger, accuracies or losses "
              "differ from the uninterrupted run")
        check(params_eq and resid_eq and ring_eq,
              f"{preset}: the resumed run's params, residuals or ring "
              "differ from the uninterrupted run")
        check(counts["stream_scatter_add"] > 0,
              f"{preset}'s legs never launched the scatter")
        if cfg.sa.enabled:
            check(counts["pair_mask_streams"] == cfg.rounds,
                  f"{preset}'s legs launched pair_mask_streams "
                  f"{counts['pair_mask_streams']} times, expected one a "
                  f"round ({cfg.rounds})")
        resume_in_fresh_process(preset, kind, ckcfg.ckpt_dir + "_cli",
                                kill_at, full_sim, full)

    vgg16_resume_leg(kind)

    # one VGG16 checkpoint: params and 10 clients' residuals
    device = torch.device("cuda")
    tree = vgg16_tree(device)
    d = str(SMOKE_DIR / "vgg16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save(d, 1, tree)
    t1 = time.perf_counter()
    back = checkpoint.restore(d, 1, like=tree)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = (all(bits_equal(back["params"][n], tree["params"][n])
                for n in tree["params"])
            and all(bits_equal(back["residuals"][c][n],
                               tree["residuals"][c][n])
                    for c in tree["residuals"] for n in tree["params"]))
    n_params = sum(p.numel() for p in tree["params"].values())
    print(f"[resume] cifar_vgg16 checkpoint on {kind}: {n_params} params + "
          f"{len(tree['residuals'])} clients' residuals, "
          f"{os.path.getsize(path) / 1e6:.1f} MB on disk: save "
          f"{(t1 - t0) * 1e3:.1f} ms, restore {(t2 - t1) * 1e3:.1f} ms, "
          f"bit-equal={same}", flush=True)
    check(same, "the VGG16 checkpoint did not restore bit-equal")
    del tree, back
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return legs_counts


# ------------------------------------------------------ phase 13: serve
SERVE_PRESET = "table2"   # the full Table 2 protocol, 28 rounds
SERVE_QPS = 1000          # offered load while it trains (open loop)
SERVE_MIN_TRAINING = 200  # requests served before training must end
BUSY_MATMULS = 120        # 8192^3 f32 products, ~20 ms each on an H100


def serve_phase(kind: str) -> dict:
    """``python -m repro_torch.serving --preset table2 --qps 1000`` through
    ``main()`` on the card, then one VGG16 publish staged through
    the watcher while the default stream is busy. Returns the CLI run's
    launch counts."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from repro_torch import checkpoint, serving
    from repro_torch.kernels import ops
    from repro_torch.models.paper_models import build_model
    from repro_torch.serving.__main__ import main as serve_main
    from repro_torch.sim import presets

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    out = SMOKE_DIR / "serve.json"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = serve_main(["--preset", SERVE_PRESET, "--qps", str(SERVE_QPS),
                         "--publish-dir", str(SMOKE_DIR / "pub"),
                         "--out", str(out)])
    counts = ops.launch_counts()
    for line in text.getvalue().splitlines():
        print(f"[serve] {line}", flush=True)
    check(rc == 0, f"python -m repro_torch.serving exited {rc}")
    trained = re.search(r"trained (\d+) rounds in ([\d.]+) s .* (\d+) of "
                        r"them before training ended", text.getvalue())
    check(trained is not None, "the serve CLI printed no training window")
    train_s, in_training = float(trained.group(2)), int(trained.group(3))
    rounds = presets.get(SERVE_PRESET).rounds
    doc = serving.load_metrics(str(out))
    req, lat, sw, st = (doc["requests"], doc["latency_us"], doc["swaps"],
                        doc["staleness"])
    print(f"[serve] {SERVE_PRESET} at {SERVE_QPS} qps on {kind}: served "
          f"{req['served']} of {req['submitted']} ({in_training} while "
          f"{rounds} rounds trained in {train_s:.3f} s; {req['errors']} "
          f"errors), latency p50 "
          f"{lat['p50']:.1f} us p99 {lat['p99']:.1f} us, swaps "
          f"{sw['count']} at steps {sw['steps']} (pause p50 "
          f"{sw['pause_us']['p50']:.2f} us max {sw['pause_us']['max']:.2f} "
          f"us), staleness mean {st['mean']:.3f} max {st['max']} over "
          f"{st['samples']} batches, launches={counts}", flush=True)
    check(serving.validate_metrics(doc) == [], "invalid serve document")
    check(req["errors"] == 0, f"{req['errors']} errored requests")
    check(sw["count"] >= 1, "no hot swap happened")
    check(in_training >= SERVE_MIN_TRAINING,
          f"only {in_training} requests were served while training ran")
    check(sw["steps"][-1] == rounds,
          f"the server settled on step {sw['steps'][-1]}, not the final "
          f"published step {rounds}")
    check(counts["stream_scatter_add"] > 0
          and counts["pair_mask_streams"] == rounds,
          f"the serve loop's training launched {counts}")

    # one VGG16 publish, staged through the watcher on its own stream while
    # the default stream holds queued work, then swapped between batches
    device = torch.device("cuda")
    vgg = build_model("cifar_vgg16")
    old = vgg16_tree(device, n_clients=0)["params"]
    new = {n: p.detach().to(device) for n, p in build_model("cifar_vgg16")
           .init_(torch.Generator().manual_seed(7)).params().items()}
    pub = str(SMOKE_DIR / "vgg16_pub")
    checkpoint.publish(pub, 1, new)
    metrics = serving.ServingMetrics()
    buffers = serving.WeightBuffers(old, step=0)
    watcher = serving.CheckpointWatcher(pub, old, buffers, metrics=metrics)
    server = serving.InferenceServer(serving.ClassifierAdapter(vgg, 8),
                                     watcher=watcher, metrics=metrics)
    x = np.random.RandomState(0).randn(*vgg.input_shape).astype(np.float32)
    busy = torch.randn(8192, 8192, device=device)
    torch.cuda.synchronize()
    b0 = torch.cuda.Event(enable_timing=True)
    b1 = torch.cuda.Event(enable_timing=True)
    b0.record()
    for _ in range(BUSY_MATMULS):             # queued on the default stream
        busy = torch.tanh(busy @ busy)
    b1.record()
    t0 = time.perf_counter()
    staged = watcher.poll_once()
    t_stage = time.perf_counter() - t0
    busy_left = not b1.query()                # still running at staging's end
    torch.cuda.synchronize()
    busy_ms = b0.elapsed_time(b1)
    ticket = server.submit(x)
    server.step(block=True)
    after = ticket.wait(60.0)
    cold = serving.InferenceServer(serving.ClassifierAdapter(vgg, 8),
                                   checkpoint.restore(pub, 1, like=old))
    ticket = cold.submit(x)
    cold.step(block=True)
    same = after.tobytes() == ticket.wait(60.0).tobytes()
    n_params = sum(p.numel() for p in new.values())
    stage = watcher.last_stage
    print(f"[serve] cifar_vgg16 publish on {kind}: {n_params} params "
          f"({4 * n_params / 1e6:.1f} MB) staged as step {staged}: host load "
          f"{stage['load_ms']:.2f} ms, side-stream copy {stage['copy_ms']:.2f} "
          f"ms (staging {t_stage * 1e3:.2f} ms while {busy_ms:.1f} ms of "
          f"work sat queued on the default stream, still running at its "
          f"end={busy_left}), swap pause {metrics.swap_pauses_us[-1]:.2f} "
          f"us, logits after the swap bit-equal to a cold restore={same}",
          flush=True)
    check(staged == 1 and buffers.active_step == 1,
          "the VGG16 publish was not staged and swapped in")
    check(busy_left, "the staging ended only after the default stream's "
          "queued work: it waited on the device, not on its own stream")
    check(same, "logits after the VGG16 swap differ from a cold restore")
    del busy, old, new, buffers, watcher, server, cold
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return counts


# ---------------------------------------------------- phase 14: sharded
# the reference's sharded == serial parity configuration
# (tests/test_client_sharded_round.py): mnist_mlp at full width, 12 clients,
# cohort 6, 3 rounds, dropout 0.4, weights by data count, mask ratio 0.02
PARITY_MESHES = (2, 3, 6)
SHARDED_PRESETS = (("tree_quick", 3), ("dp_quick", 2))
INT8_SHARDS = 5            # codec_sweep_quick's int8 arm, cohort 5
VGG_SHARDS = 5             # table2 protocol, cohort 5: one client a shard
# VGG16's sharded run against the plain serial one, under deterministic
# cuDNN: cuDNN picks its convolution algorithm by batch shape, so a shard's
# local SGD (2 rows) rounds otherwise than the cohort's (5 rows); the rest
# of the round is held bit-exact apart. The limit on the largest param
# difference after the 2 rounds is 1.5 times the reading that PERF.md
# section 6 records for this script (1.579433e-02, the same in every run,
# as the run is deterministic)
VGG_PARAM_ATOL = 2.4e-2


def parity_config():
    from repro_torch.core.types import SecureAggConfig, THGSConfig
    from repro_torch.sim.config import SimConfig

    return SimConfig(
        name="parity", model="mnist_mlp", dataset="mnist", rounds=3,
        n_clients=12, clients_per_round=6, n_train=600, n_test=200,
        local_steps=2, local_batch=16, eval_every=1,
        thgs=THGSConfig(s0=0.05, alpha=0.9, s_min=0.01),
        sa=SecureAggConfig(mask_ratio=0.02, seed=3), dropout_rate=0.4,
        weight_by_data_count=True, seed=1, shard_clients="off")


def row_launch_rows(device) -> list:
    """The pair-mask kernel's row launch (a shard's rows of the seed
    matrix, ``rows = C_loc < peers = C``, no mirror) at mnist_mlp's 4 leaves
    (6 clients, shards of 2 and 3) and VGG16's 54 (5 clients, one a shard):
    every shard's launch bit-equal to the plain version and to its rows of
    the mirrored round launch; the raw launch of one shard (CUDA graph)
    beside the wrapper, the plain version and the bound."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import mask_prng, ref

    out = []
    for model, C, c_locs in (("mnist_mlp", 6, (2, 3)),
                             ("cifar_vgg16", 5, (1,))):
        seeds, signs, _, _, leaves = model_round(model, C)
        sd, gd = se.round_matrices(device, seeds, signs)
        whole = se.mask_streams_round(sd, gd, leaves, p=-1.0, q=2.0)
        for c_loc in c_locs:
            tag = f"{model} row launch ({len(leaves)} leaves, C_loc={c_loc} " \
                  f"of C={C})"
            before = mask_prng.launches
            err = 0.0
            for i0 in range(0, C, c_loc):
                sr, gr = sd[i0:i0 + c_loc], gd[i0:i0 + c_loc]
                got = se.mask_streams_rows_round(sr, gr, leaves, p=-1.0,
                                                 q=2.0)
                plain = ref.pair_mask_segments_ref(sr, gr, leaves)
                for leaf, (i, v), (pi, pv), (wi, wv) in zip(
                        leaves, got, plain, whole):
                    check(bits_equal(i, pi) and bits_equal(v, pv),
                          f"{tag}: shard at {i0} != plain at leaf {leaf[3]}")
                    check(bits_equal(i, wi[i0:i0 + c_loc])
                          and bits_equal(v, wv[i0:i0 + c_loc]),
                          f"{tag}: shard at {i0} != its rows of the mirrored "
                          f"round launch at leaf {leaf[3]}")
                    err = max(err, (v - pv).abs().max().item())
            torch.cuda.synchronize()
            n_launch = mask_prng.launches - before
            check(n_launch == C // c_loc,
                  f"{tag}: {n_launch} launches for {C // c_loc} shards")
            sr, gr = sd[:c_loc], gd[:c_loc]
            outs = se.mask_streams_rows_round(sr, gr, leaves, p=-1.0, q=2.0)
            launch = raw_mask_launch(
                sr, gr, c_loc, C, 0, None,
                [(i, v, nb, k, m, leaf) for (i, v), (nb, k, m, leaf)
                 in zip(outs, leaves)])
            ms = graph_ms(launch)
            wrapper_ms = events_ms(lambda: se.mask_streams_rows_round(
                sr, gr, leaves, p=-1.0, q=2.0))
            plain_ms = events_ms(lambda: ref.pair_mask_segments_ref(
                sr, gr, leaves), reps=3, inner=3)
            slots = sum(c_loc * C * nb * k for nb, k, _, _ in leaves)
            bound_ms, bound_by = bound(8 * slots + 8 * c_loc * C,
                                       MASK_OPS_PER_SLOT * slots)
            out.append(dict(shape=tag, n=slots, ms=ms, wrapper_ms=wrapper_ms,
                            plain_ms=plain_ms, library_ms=None,
                            bound_ms=bound_ms, bound_by=bound_by,
                            max_abs_err=err))
            print(f"[sharded] pair_mask_streams {tag}: {C // c_loc} shard "
                  f"launches, each bit-equal to plain and to its rows of the "
                  f"mirrored launch=yes; one shard: slots={slots} "
                  f"ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}",
                  flush=True)
    return out


def states_equal(a, b) -> tuple[bool, bool]:
    params = all(bits_equal(a.params[n], b.params[n]) for n in b.params)
    resid = (sorted(a.residuals) == sorted(b.residuals)
             and all(bits_equal(a.residuals[c][n], b.residuals[c][n])
                     for c in b.residuals for n in b.params))
    return params, resid


def timed_run(cfg, shards: int, device, log: list | None = None):
    """One run of ``cfg`` on the card, serial (0) or over ``shards``
    shards of ``device``; counts reset before, and each round's launches
    read by a round hook; ``log`` gets each leaf's (name, updates).
    Returns (sim, result, per-round launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ClientsMesh
    from repro_torch.sim.engine import Simulation

    sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                     device="cuda")
    if shards:
        sim.mesh = ClientsMesh((device,) * shards)
    if log is not None:
        sim.leaf_hook = lambda leaf_id, name, info: log.append(
            (name, info["updates"].clone()))
    per_round, prev = [], {}

    def round_hook(r, info):
        now = ops.launch_counts()
        per_round.append((r, list(info["dropped"]),
                          {n: now[n] - prev.get(n, 0) for n in now}))
        prev.update(now)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run(resume=False, hooks=[round_hook])
    return sim, res, per_round


def leafwise_check(cfg, shards: int, device, log: list | None = None
                   ) -> dict:
    """The serial run with a leaf hook that feeds each leaf's encode inputs
    (the serial round's deltas and residuals, its masks' seeds and its
    dropout) to ``encode_decode_leaf_sharded`` over ``shards`` shards of
    ``device``, and holds the decoded sum and the new residuals bit-equal to
    the serial round's. Returns the leaves checked, those that differ, the
    run's final state (a second serial run) and the bytes the sharded round's gathers move a round (the stream or its
    packed words, and the residuals), summed over the run. ``log`` gets
    each leaf's (round, name, updates)."""
    import torch

    from repro_torch.core import codecs
    from repro_torch.core import streams as se
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import ClientsMesh
    from repro_torch.sim.engine import Simulation

    mesh = ClientsMesh((device,) * shards)
    sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                     device="cuda")
    out = {"leaves": 0, "differ": [], "stream_bytes": 0, "residual_bytes": 0}

    def hook(leaf_id, name, info):
        size, C = info["size"], info["updates"].shape[0]
        dropped = bool(info["dropped"])
        dense, nr, st = se.encode_decode_leaf_sharded(
            mesh, info["updates"], info["residuals"], k=info["k"], nb=1,
            m=size, size=size, pair_seeds=info["pair_seeds"],
            pair_signs=info["pair_signs"],
            recovery_seeds=info["recovery_seeds"],
            alive=info["alive"] if dropped else None,
            k_mask=info["k_mask"], mask_p=cfg.sa.p, mask_q=cfg.sa.q,
            leaf_id=leaf_id, weights=info["weights"], codec=info["codec"],
            topology=cfg.topology, tree_groups=cfg.tree_groups,
            dp_sigma=info["dp_sigma"], dp_seeds=info["dp_seeds"],
            dp_support_seed=info["dp_support_seed"])
        same = (bits_equal(dense, info["dense"])
                and bits_equal(nr, info["new_residuals"])
                and bits_equal(st.indices, info["streams"].indices)
                and bits_equal(st.values, info["streams"].values))
        if log is not None:
            log.append((name, info["updates"].clone()))
        out["leaves"] += 1
        if not same:
            out["differ"].append((out["leaves"] - 1, name))
        if info["codec"] == "f32":
            st = info["streams"]
            out["stream_bytes"] += st.indices.nbytes + st.values.nbytes
        else:
            k = min(info["k"], size)
            words = (ref.packed_words(k, codecs.index_width(size))
                     + ref.packed_words(k, codecs.value_bits(info["codec"])))
            out["stream_bytes"] += 4 * C * (words + 1)
        out["residual_bytes"] += info["new_residuals"].nbytes

    sim.leaf_hook = hook
    sim.run(resume=False)
    torch.cuda.synchronize()
    out["state"] = sim.state
    return out


def first_divergence(cfg, shards: int, device) -> str:
    """Where a sharded run first leaves the serial one: each leaf's local
    SGD deltas, then its decoded sum, compared round by round."""
    from repro_torch.launch.mesh import ClientsMesh
    from repro_torch.sim.engine import Simulation

    logs = []
    for mesh in (None, ClientsMesh((device,) * shards)):
        sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                         device="cuda")
        sim.mesh = mesh
        log = []
        sim.leaf_hook = lambda leaf_id, name, info, log=log: log.append(
            (name, info["updates"].clone(), info["dense"].clone()))
        sim.run(resume=False)
        logs.append(log)
    n_leaves = len(Simulation(cfg.replace(out_json=None), device="cuda")
                   .model.leaf_names())
    for i, ((name, u0, d0), (_, u1, d1)) in enumerate(zip(*logs)):
        r = i // n_leaves
        if not bits_equal(u0, u1):
            return (f"round {r} leaf {name}: the local SGD deltas differ "
                    f"(max abs {(u0 - u1).abs().max().item():.3e})")
        if not bits_equal(d0, d1):
            return (f"round {r} leaf {name}: equal deltas, the decoded sum "
                    f"differs (max abs {(d0 - d1).abs().max().item():.3e})")
    return "no leaf differs"


def compare_sharded(tag: str, cfg, serial, shards: int, device) -> dict:
    """A sharded run of ``cfg`` against the serial one (``serial`` = (sim,
    result, per-round launches)): params, every client's residuals, ledger
    entries and accuracies bit-equal; where they are not, the first round
    and leaf that differ are named and the phase fails. Returns the row
    printed."""
    sim0, res0, _ = serial
    sim, res, per_round = timed_run(cfg, shards, device)
    row = run_row(tag, shards, cfg, (sim, res, per_round), serial)
    if not row["exact"]:
        fail(f"{tag} over {shards} shards is not bit-equal: first "
             f"divergence {first_divergence(cfg, shards, device)}")
    return row


def run_row(tag: str, shards: int, cfg, run, serial) -> dict:
    """Hold one run against another (params, residuals, ledger entries,
    accuracies, losses, bit for bit) and print the comparison beside both
    runs' round times and the sharded run's launches a round."""
    (sim, res, per_round), (sim0, res0, _) = run, serial
    params_eq, resid_eq = states_equal(sim.state, sim0.state)
    ledger_eq = res.ledger.entries == res0.ledger.entries
    accs_eq = res.accuracies == res0.accuracies
    row = dict(tag=tag, shards=shards,
               exact=params_eq and resid_eq and ledger_eq and accs_eq,
               params_eq=params_eq, resid_eq=resid_eq, ledger_eq=ledger_eq,
               accs_eq=accs_eq, losses_eq=res.losses == res0.losses,
               round_s=res.wall_s / cfg.rounds,
               serial_round_s=res0.wall_s / cfg.rounds,
               per_round=per_round)
    print(f"[sharded] {tag} over {shards} shards of one card: params "
          f"bit-equal={params_eq} residuals bit-equal={resid_eq} ledger "
          f"entries equal={ledger_eq} accuracies equal={accs_eq} losses "
          f"equal={row['losses_eq']}; round {row['round_s']:.4f} s (serial "
          f"{row['serial_round_s']:.4f} s); launches a round "
          f"{[(r, d, {n: c for n, c in x.items() if c}) for r, d, x in per_round]}",
          flush=True)
    return row


def round_inputs(cfg, device):
    """The first round's inputs of ``cfg``'s engine on the card: (params,
    stacked client batches, loss, FedConfig)."""
    import torch

    from repro_torch.sim.engine import Simulation

    sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                     device="cuda")
    batches = sim._batches_for(0, sim.sampler.cohort_for(0))
    parts = sorted(batches)
    stacked = tuple(torch.stack([batches[c][i] for c in parts])
                    for i in range(len(batches[parts[0]])))
    return sim._fresh_state().params, stacked, sim.loss_fn, sim.fed


def pad_readings(tag: str, cfg, device, reps: int) -> dict:
    """The one-client shard's local SGD at ``cfg``'s first round, over one
    shard a client of ``device``: with its duplicated row (``pad_one``, the
    default) and without, each held against the serial cohort's deltas (bit
    for bit or not, and the largest difference) and timed on the host clock
    (median of ``reps``)."""
    import torch

    from repro_torch.core import fedavg
    from repro_torch.core import streams as se
    from repro_torch.launch.mesh import ClientsMesh

    params, batches, loss_fn, fed = round_inputs(cfg, device)
    C = batches[0].shape[0]
    mesh = ClientsMesh((device,) * C)
    whole, _ = fedavg.batched_client_update(params, batches, loss_fn,
                                            fed.local_steps, fed.local_lr)
    out = {}
    for pad in (True, False):
        def sgd():
            return fedavg.batched_client_update_sharded(
                mesh, params, batches, loss_fn, fed.local_steps,
                fed.local_lr, pad_one=pad)[0]

        got = se.all_gather_round(sgd(), device)
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sgd()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[pad] = dict(
            bit_equal=all(bits_equal(got[n], whole[n]) for n in whole),
            max_abs=max((got[n] - whole[n]).abs().max().item()
                        for n in whole),
            ms=1e3 * statistics.median(ts))
    print(f"[sharded] {tag}: local SGD of {C} one-client shards, first "
          f"round: with the duplicated row bit-equal to the cohort's="
          f"{out[True]['bit_equal']} (max abs {out[True]['max_abs']:.6e}) "
          f"{out[True]['ms']:.3f} ms; without it bit-equal="
          f"{out[False]['bit_equal']} (max abs {out[False]['max_abs']:.6e}) "
          f"{out[False]['ms']:.3f} ms (median of {reps})", flush=True)
    return out


class sgd_at_shard_shape:
    """Inside the block the serial round's local SGD runs shard by shard at
    the sharded round's batch shapes: ``c_loc`` clients a call (a
    one-client shard as two rows, keeping the first), each through the
    unchanged ``batched_client_update``; the encode and the decode stay
    serial. A sharded run must be bit-equal to such a run."""

    def __init__(self, c_loc: int):
        self.c_loc = c_loc

    def __enter__(self):
        import torch

        from repro_torch.core import fedavg

        self.real = real = fedavg.batched_client_update
        c_loc = self.c_loc

        def per_shard(params, batches, *a, **kw):
            parts = []
            for i0 in range(0, batches[0].shape[0], c_loc):
                b = tuple(x[i0:i0 + c_loc] for x in batches)
                if c_loc == 1:
                    b = tuple(torch.cat([x, x]) for x in b)
                d, losses = real(params, b, *a, **kw)
                parts.append(({n: v[:c_loc] for n, v in d.items()},
                              losses[:c_loc]))
            return ({n: torch.cat([d[n] for d, _ in parts])
                     for n in parts[0][0]},
                    torch.cat([losses for _, losses in parts]))

        fedavg.batched_client_update = per_shard

    def __exit__(self, *exc):
        from repro_torch.core import fedavg

        fedavg.batched_client_update = self.real


def vgg16_sharded(cfg, shards: int, device) -> dict:
    """VGG16 over ``shards`` one-client shards under deterministic cuDNN
    (module docstring, phase 14). Returns the row printed."""
    import torch

    serial = timed_run(cfg, 0, device)
    serial_log = []
    lw = leafwise_check(cfg, shards, device, log=serial_log)
    print(f"[sharded] cifar_vgg16: the sharded encode/decode fed the "
          f"serial run's deltas over {shards} shards: {lw['leaves']} "
          f"leaves, bit-equal except {lw['differ']}; per round the "
          f"gather moves {lw['stream_bytes'] / cfg.rounds:.0f} stream "
          f"bytes and the residual return "
          f"{lw['residual_bytes'] / cfg.rounds:.0f} bytes", flush=True)
    check(not lw["differ"], f"VGG16: the sharded encode/decode fed the "
          f"serial deltas differs at leaves {lw['differ']}")
    check(states_equal(lw["state"], serial[0].state) == (True, True),
          "VGG16: two serial runs under deterministic cuDNN differ")
    shaped_log, sharded_log = [], []
    with sgd_at_shard_shape(cfg.clients_per_round // shards):
        shaped = timed_run(cfg, 0, device, log=shaped_log)
    sharded = timed_run(cfg, shards, device, log=sharded_log)
    exact = run_row("cifar_vgg16 table2 (serial local SGD at the "
                    "shard shape)", shards, cfg, sharded, shaped)
    sgd_eq = len(shaped_log) == len(sharded_log) and all(
        bits_equal(a[1], b[1]) for a, b in zip(shaped_log, sharded_log))
    check(exact["exact"] and sgd_eq,
          "VGG16: the sharded run is not bit-equal to the serial run "
          "whose local SGD runs at the shard shape (local SGD deltas "
          f"bit-equal={sgd_eq})")
    row = run_row("cifar_vgg16 table2", shards, cfg, sharded, serial)
    p0, p1 = serial[0].state.params, sharded[0].state.params
    first = next((f"round {i // len(p0)} leaf {n}" for i, ((n, a), (_, b))
                  in enumerate(zip(serial_log, sharded_log))
                  if not bits_equal(a, b)), "none")
    init = serial[0]._fresh_state().params
    diff = max((p1[n] - p0[n]).abs().max().item() for n in p0)
    rel = (sum(((p1[n] - p0[n]) ** 2).sum().item() for n in p0)
           / sum(((p0[n] - init[n]) ** 2).sum().item() for n in p0)) ** 0.5
    row.update(first_divergence=first, max_param_diff=diff, rel_l2=rel)
    print(f"[sharded] cifar_vgg16 over {shards} shards against the plain "
          f"serial run (deterministic cuDNN): first difference in the local "
          f"SGD deltas at {first}; after {cfg.rounds} rounds the params "
          f"differ by max abs {diff:.6e} (limit {VGG_PARAM_ATOL:.1e}), "
          f"||diff|| / ||serial update|| {rel:.6e}; the sharded run equals "
          f"the serial run with local SGD at the shard shape bit for bit",
          flush=True)
    check(diff <= VGG_PARAM_ATOL, f"VGG16: params differ by {diff:.3e}, over "
          f"the limit {VGG_PARAM_ATOL:.1e}")
    del serial, lw, shaped, sharded, serial_log, shaped_log, sharded_log
    torch.cuda.empty_cache()
    return row


def sharded_phase(kind: str, card: str, device) -> tuple[dict, list]:
    """Phase 14 (module docstring). Returns the launches of the parity
    runs over 2, 3 and 6 shards and of the int8 arm's sharded run (the
    sharded main path), and the row launch's kernel rows."""
    import torch

    from repro_torch.sim import presets

    t_phase = time.perf_counter()
    rows = row_launch_rows(device)
    counts = {}

    def add(per_round):
        for _, _, x in per_round:
            for n, c in x.items():
                counts[n] = counts.get(n, 0) + c

    # the reference's parity config over 2, 3 and 6 shards
    cfg = parity_config()
    n_leaves = 4
    timed_run(cfg.replace(rounds=1), 0, device)          # warm-up
    serial = timed_run(cfg, 0, device)
    lw = leafwise_check(cfg, 2, device)
    check(not lw["differ"], f"parity: the sharded encode/decode fed the "
          f"serial deltas differs at leaves {lw['differ']}")
    dropout_rounds = sum(bool(d) for _, d, _ in serial[2])
    check(dropout_rounds >= 1, "the parity config dropped no client")
    results = []
    for shards in PARITY_MESHES:
        row = compare_sharded("parity (mnist_mlp, cohort 6)", cfg, serial,
                              shards, device)
        for r, dropped, x in row["per_round"]:
            want = shards + (1 if dropped else 0)
            check(x["pair_mask_streams"] == want,
                  f"parity over {shards} shards, round {r}: "
                  f"{x['pair_mask_streams']} pair-mask launches, expected "
                  f"{want}")
            check(x["stream_scatter_add"] == n_leaves,
                  f"parity over {shards} shards, round {r}: "
                  f"{x['stream_scatter_add']} scatter launches, expected "
                  f"{n_leaves}")
        add(row["per_round"])
        results.append(row)
    print(f"[sharded] parity: {dropout_rounds} dropout round(s); per "
          f"round the gather moves {lw['stream_bytes'] / cfg.rounds:.0f} "
          f"stream bytes and the residual return "
          f"{lw['residual_bytes'] / cfg.rounds:.0f} bytes (each copied "
          f"device to device on {card})", flush=True)

    # tree_quick over 3 shards, dp_quick over 2
    for preset, shards in SHARDED_PRESETS:
        cfg = presets.get(preset)
        serial = timed_run(cfg, 0, device)
        lw = leafwise_check(cfg, shards, device)
        check(not lw["differ"], f"{preset}: the sharded encode/decode fed "
              f"the serial deltas differs at leaves {lw['differ']}")
        row = compare_sharded(preset, cfg, serial, shards, device)
        for r, dropped, x in row["per_round"]:
            want = shards + (1 if dropped else 0)
            check(x["pair_mask_streams"] == want,
                  f"{preset} over {shards} shards, round {r}: "
                  f"{x['pair_mask_streams']} pair-mask launches, expected "
                  f"{want}")
        results.append(row)

    # codec_sweep_quick's int8 arm over 5 shards
    cfg = presets.sweep_configs("codec_sweep_quick")["int8"]
    serial = timed_run(cfg, 0, device)
    lw = leafwise_check(cfg, INT8_SHARDS, device)
    check(not lw["differ"], f"int8: the sharded encode/decode fed the "
          f"serial deltas differs at leaves {lw['differ']}")
    row = compare_sharded("codec_sweep_quick int8", cfg, serial, INT8_SHARDS,
                          device)
    for r, _, x in row["per_round"]:
        check(x["bitpack_rows"] == INT8_SHARDS * n_leaves
              and x["bitunpack_rows"] == n_leaves,
              f"int8 over {INT8_SHARDS} shards, round {r}: "
              f"{x['bitpack_rows']} pack and {x['bitunpack_rows']} unpack "
              f"launches, expected {INT8_SHARDS * n_leaves} and {n_leaves}")
    add(row["per_round"])
    results.append(row)
    print(f"[sharded] int8: per round the gather moves "
          f"{lw['stream_bytes'] / cfg.rounds:.0f} bytes of packed words and "
          f"scales and the residual return "
          f"{lw['residual_bytes'] / cfg.rounds:.0f} bytes", flush=True)

    pad = pad_readings("codec_sweep_quick int8", cfg, device, reps=7)
    check(pad[True]["bit_equal"], "int8: the one-client shards' local SGD "
          "with the duplicated row is not bit-equal to the cohort's")

    # VGG16 under the table2 protocol, 2 rounds over 5 shards
    cfg = vgg16_table2()
    pad_readings("cifar_vgg16 table2 (deterministic cuDNN)", cfg, device,
                 reps=3)
    row = vgg16_sharded(cfg, VGG_SHARDS, device)
    for r, dropped, x in row["per_round"]:
        check(x["pair_mask_streams"] == VGG_SHARDS,
              f"VGG16 round {r}: {x['pair_mask_streams']} pair-mask "
              f"launches, expected {VGG_SHARDS}")
    results.append(row)
    torch.cuda.empty_cache()
    print(f"[sharded] phase 14 took {time.perf_counter() - t_phase:.1f} s "
          f"({card}): " + "; ".join(
              f"{r['tag']} x{r['shards']}: round {r['round_s']:.4f} s vs "
              f"serial {r['serial_round_s']:.4f} s exact={r['exact']}"
              for r in results), flush=True)
    return counts, rows


# ------------------------------------------------------- phase 15: bench
BENCH_KERNELS = ("stream_scatter_add", "pair_mask_streams", "bitpack_rows",
                 "bitunpack_rows", "flash_attention")
# the single-device rows of the reference's BENCH_round.json
BENCH_ROUND_NAMES = ["round/model_size_c8", "round/serial_c8",
                     "round/serial_dropout_c8", "round/sharded_c8"]


def bench_names() -> dict:
    """Each suite's expected ``--quick`` entry names: the reference's
    committed quick names (``BENCH_<suite>.json``; for ``round`` its
    single-device rows)."""
    out = {"round": BENCH_ROUND_NAMES}
    for suite in ("agg", "cohort", "serve"):
        with open(ROOT / f"BENCH_{suite}.json") as f:
            out[suite] = [e["name"] for e in json.load(f)["entries"]]
    return out


# the agg suite's loop round (per-client means, summed client by client)
# against its batched round (one sum, then / C): the same slots added in
# another order. The limit is 2 times the reading that PERF.md section 6
# records for this script (2.980232e-08 on an H100, the same bits as the
# plain versions give on the CPU)
LOOP_BATCHED_ATOL = 6e-8


def bench_path_checks(device) -> None:
    """Phase 15's kernel and helper checks at the suites' ``--quick`` shapes,
    on the suites' own inputs (module docstring)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.bench import agg_bench, cohort_bench
    from repro_torch.core import codecs, streams
    from repro_torch.core.masks import client_masks, pair_mask
    from repro_torch.core.secure_agg import encode_leaf
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import default_tree_groups

    cpu = torch.device("cpu")
    size, C = agg_bench.QUICK_SIZE, agg_bench.QUICK_CLIENTS
    x = agg_bench.round_inputs(size, C, device)
    xc = agg_bench.round_inputs(size, C, cpu)
    sa, P, k, km, thgs = x["sa"], x["participants"], x["k"], x["k_mask"], \
        x["thgs"]

    def mask_eq(a, b) -> bool:
        return (bits_equal(a.indices.cpu(), b.indices)
                and bits_equal(a.values.cpu(), b.values))

    for a in P:
        for b in P:
            if a != b:
                check(mask_eq(pair_mask(sa, a, b, 0, 0, size, km,
                                        device=device),
                              pair_mask(sa, a, b, 0, 0, size, km,
                                        device=cpu)),
                      f"pair_mask({a}, {b}) on the card != on the CPU")
    for ci, c in enumerate(P):
        mg = client_masks(sa, c, P, 0, 0, size, km, device=device)
        mc = client_masks(sa, c, P, 0, 0, size, km, device=cpu)
        check(mask_eq(mg, mc), f"client_masks({c}) on the card != on the CPU")
        eg = encode_leaf(x["grads"][ci], x["residuals"][ci], k, thgs, mg)
        ec = encode_leaf(xc["grads"][ci], xc["residuals"][ci], k, thgs, mc)
        check(bits_equal(eg.stream.indices.cpu(), ec.stream.indices)
              and bits_equal(eg.stream.values.cpu(), ec.stream.values)
              and bits_equal(eg.residual.cpu(), ec.residual),
              f"encode_leaf of client {c} on the card != on the CPU")
    print(f"[bench] agg inputs (C={C}, m={size}, k={k}, k_mask={km}): "
          f"pair_mask x{C * (C - 1)}, client_masks and encode_leaf x{C} "
          f"bit-equal to the CPU's", flush=True)

    seeds = torch.arange(1, C * C + 1, dtype=torch.int64, device=device)
    signs = torch.ones((C * C,), dtype=torch.float32, device=device)
    got = ops.pair_mask_streams(seeds, signs, nb=1, k_mask=km, m=size,
                                p=sa.p, q=sa.q)
    plain = ref.pair_mask_stream_ref(seeds, signs, 1, km, size, p=sa.p,
                                     q=sa.q)
    check(all(bits_equal(g, w) for g, w in zip(got, plain)),
          f"the agg micro's {C * C}-pair mask launch != plain")

    loop = agg_bench._loop_round(x["grads"], x["residuals"], k, thgs, sa, P,
                                 size, device)
    loop_cpu = agg_bench._loop_round(xc["grads"], xc["residuals"], k, thgs,
                                     sa, P, size, cpu)
    st, _ = streams.encode_leaf_batch(
        x["grads"], x["residuals"], k=k, nb=1, m=size, size=size,
        pair_seeds=x["pair_seeds"], pair_signs=x["pair_signs"], k_mask=km,
        mask_p=sa.p, mask_q=sa.q, leaf_id=0)
    batched = streams.decode_leaf_batch(st, nb=1, m=size, size=size)
    gap = (loop - batched / C).abs().max().item()
    print(f"[bench] agg loop round: bit-equal to the CPU's="
          f"{bits_equal(loop.cpu(), loop_cpu)}; max |loop - batched / C| "
          f"{gap:.6e} (limit {LOOP_BATCHED_ATOL:.1e}, max |loop| "
          f"{loop.abs().max().item():.4f})", flush=True)
    check(bits_equal(loop.cpu(), loop_cpu),
          "the agg loop round on the card != on the CPU")
    check(gap <= LOOP_BATCHED_ATOL, f"the agg loop round is {gap:.3e} from "
          "the batched round's mean")

    csize, ck, _ = cohort_bench.leaf(quick=True)
    for n in cohort_bench.COHORTS:
        cs = cohort_bench.cohort_streams(n, csize, ck, device)
        plain = ref.stream_scatter_add_ref(cs.indices.reshape(-1),
                                           cs.values.reshape(-1), csize)
        splits = streams.tree_splits(csize, default_tree_groups(n))
        check(bits_equal(streams.decode_sum_blocks(cs, 1, csize), plain)
              and bits_equal(streams.decode_sum_tree(cs, 1, csize,
                                                     splits=splits), plain),
              f"cohort c{n}: the flat or tree decode != plain")
    print(f"[bench] cohort streams c{cohort_bench.COHORTS} ({ck} slots a "
          f"client into {csize}): flat and tree decodes bit-equal to plain",
          flush=True)

    rs = np.random.RandomState(21)
    for codec in ("int8", "int4", "1bit"):
        widths = [codecs.index_width(size), codecs.value_bits(codec)]
        fields = [pack_fields(rs, C, k, w, device).to(torch.int32)
                  for w in widths]
        words = ops.bitpack_segments(fields, widths=widths)
        back = ops.bitunpack_segments(words, ks=[k, k], widths=widths)
        check(all(bits_equal(g, w) for g, w in
                  zip(words, ref.bitpack_segments_ref(fields, widths)))
              and all(bits_equal(g, w) for g, w in
                      zip(back, ref.bitunpack_segments_ref(words, [k, k],
                                                           widths)))
              and all(bits_equal(g, u) for g, u in zip(back, fields)),
              f"the {codec} packs at {C}x{k} != plain or no round trip")
    print(f"[bench] codec packs at {C}x{k} (widths {codecs.index_width(size)}"
          f" + 8 / 4 / 1): bit-equal to plain, round trip exact", flush=True)

    cfg = configs.reduced(configs.get("yi_6b"))
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_model // cfg.n_heads
    q, kk, v, _ = flash_inputs(4, 16, 16, H, Hkv, hd, torch.float32, True,
                               None, None, 121, device)
    out = ops.flash_attention(q, kk, v, causal=True)
    plain = ref.flash_attention_ref(q, kk, v, causal=True)
    err = (out - plain).abs().max().item()
    print(f"[bench] flash f32 at the reduced Yi-6B prefill (B 4, T 16, H {H},"
          f" Hkv {Hkv}, hd {hd}): max abs err {err:.3e} (tolerance 2e-5)",
          flush=True)
    check(out.shape == q.shape and torch.allclose(out, plain, rtol=2e-5,
                                                  atol=2e-5),
          f"flash f32 at the reduced Yi-6B prefill off by {err:.3e}")


def bench_phase(kind: str, card: str) -> dict:
    """Phase 15 (module docstring): ``python -m repro_torch.bench --quick
    --out`` through its ``main()`` on the card, counts reset before and read
    after; the document, its env and names; the gate against the committed
    ``BENCH_torch_*.json``; the paper-table drivers' CSV rows. Returns the
    suites' launch counts."""
    import contextlib
    import io
    import shutil

    import torch

    from repro_torch.bench import JSON_SUITES, schema
    from repro_torch.bench.__main__ import main as bench_main
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    out_dir = SMOKE_DIR / "bench"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    out = str(out_dir / "bench_quick.json")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rc = bench_main(["--quick", "--out", out])
    counts = ops.launch_counts()
    t_suites = time.perf_counter() - t_phase
    check(rc == 0, f"python -m repro_torch.bench --quick exited {rc}")
    doc = schema.load_doc(out)
    env = doc["env"]
    name, limit = (x.strip() for x in card.rsplit(",", 1))
    print(f"[bench] repro_torch.bench --quick on {kind}: {t_suites:.1f} s, "
          f"env={env}, launches={counts}", flush=True)
    check(doc["quick"] and env["backend"] == "cuda",
          f"the bench document is not a --quick CUDA run: {env}")
    check(env["device_name"] == name and env["power_limit"] == limit,
          f"the bench env names {env['device_name']!r} at "
          f"{env['power_limit']!r}, nvidia-smi says {card!r}")
    for kname in BENCH_KERNELS:
        check(counts[kname] >= 1, f"the bench suites never launched {kname}")
    want = bench_names()
    for suite, entries in doc["suites"].items():
        got = [e["name"] for e in entries]
        check(got == want[suite], f"bench suite {suite}: entry names {got}, "
              f"expected the reference's {want[suite]}")
        for e in entries:
            print(f"[bench]   {e['name']} {e['us_per_call']} us "
                  f"{e['derived']}", flush=True)
    check(list(doc["suites"]) == list(JSON_SUITES),
          f"the bench document holds suites {list(doc['suites'])}")
    # the CLI prints the count compared and any regression; it exits 1 on
    # a regression and when nothing was compared
    baselines = [str(ROOT / f) for _, f in JSON_SUITES.values()]
    gate_rc = bench_main(["--gate", out] + [
        a for p in baselines for a in ("--baseline", p)])
    check(gate_rc == 0, f"the gate against the committed BENCH_torch_*.json "
          f"exited {gate_rc}")
    bench_path_checks(torch.device("cuda"))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        csv_rc = bench_main(["--csv", "--only", "table1,table2,fig1,fig3",
                             "--quick"])
    rows = buf.getvalue().splitlines()
    for row in rows:
        print(f"[bench] csv {row}", flush=True)
    check(csv_rc == 0 and not any("/ERROR," in r for r in rows),
          f"the paper-table drivers failed (rc {csv_rc})")
    check(len(rows) == 1 + 4 + 6 + 6 + 2,
          f"the paper-table drivers printed {len(rows) - 1} rows, expected "
          "table1 4, table2 6, fig1 6, fig3 2")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[bench] phase 15 took {time.perf_counter() - t_phase:.1f} s "
          f"(suites {t_suites:.1f} s, paper tables "
          f"{time.perf_counter() - t0:.1f} s) on {card}", flush=True)
    return counts


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port on one NVIDIA GPU (see the module "
                                 "docstring).")
    ap.add_argument("--only",
                    choices=["flash", "pack", "masks", "sharded", "bench",
                             "families"],
                    help="run the device and build phases and then [flash] "
                    "(the HGMMA count printed, not required), the bit-pack "
                    "kernels' checks and times and one codec_wire_roundtrip "
                    "probe, the pair-mask kernel's flat and round rows "
                    "and one round's mask path probe, [sharded], [bench] "
                    "or [families] alone, with no result line: a kernel's "
                    "times on a "
                    "tree, for a comparison of two trees in one call")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs one "
             "CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi unavailable"
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} kind={kind} "
          f"count={torch.cuda.device_count()}", flush=True)
    from repro_torch.kernels import build, ops

    build.build_all(verbose=True)
    print(f"[build] {len(build.SOURCES)} CUDA sources built in "
          f"{build.build_seconds:.1f} s into {build.build_dir()}", flush=True)
    from repro_torch.core import schedules
    from repro_torch.core.types import SecureAggConfig, THGSConfig
    from repro_torch.models.paper_models import build_model

    thgs = THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    sa = SecureAggConfig(mask_ratio=0.01)
    shapes = []
    for model, leaf, rounds in (("mnist_mlp", "l0.w", 12),
                                ("cifar_vgg16", "c10.w", 28)):
        names = build_model(model).leaf_names()
        sizes = [build_model(model).params()[n].numel() for n in names]
        i = names.index(leaf)
        k = schedules.leaf_ks(thgs, sizes, t=0, total_rounds=rounds)[i]
        shapes.append((f"{model}.{leaf}", sizes[i], k,
                       sa.k_mask_for(sizes[i], 5), 5))
    # VGG16's 512x512x3x3 leaf at the largest round-0 k of its quantized
    # levels that an earlier leaf position would draw (a denser stream)
    shapes.append(("cifar_vgg16.512x512x3x3@k60199", 2359296, 60199,
                   sa.k_mask_for(2359296, 5), 5))
    if args.only == "flash":      # any tree, the parent's CUDA-core kernel too
        flash_phase(device, require_hgmma=False)
        print(f"[done] --only flash passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "pack":     # any tree, the parent's unsegmented packs too
        pack_kernel_phase(device)
        wire_roundtrip_probe(device)
        print(f"[done] --only pack passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "bench":
        bench_phase(kind, card)
        print(f"[done] --only bench passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "families":
        families_phase(card)
        print(f"[done] --only families passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "sharded":
        sharded_phase(kind, card, device)
        print(f"[done] --only sharded passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "masks":    # any tree, the parent's per-leaf launches too
        mask_round_rows(device)
        flat_mask_rows(shapes[::2], device)
        mask_path_probe(device)
        print(f"[done] --only masks passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0

    # -------------------------------------------------------- 2. kernels
    rows = kernel_phase(shapes, device)
    # the round launch first: it is what the main path launches
    rows["pair_mask_streams"] = (mask_round_rows(device)
                                 + flat_mask_rows(shapes[::2], device))
    mask_path_probe(device)
    rows["stream_scatter_add"].append(scatter_tree_group_row(device))
    scatter_cases(device)
    rows.update(pack_kernel_phase(device))
    split_rows, split_counts = split_mask_kernel_phase(device)
    rows.update(split_rows)

    # ------------------------------------------------------ 3. main path
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get("table2_quick").replace(out_json=None)
    # one warm-up round first (cuBLAS handles, allocator, first launches), so
    # the main run's wall time is the steady state
    Simulation(cfg.replace(rounds=1), device="cuda").run()
    sim = Simulation(cfg, device="cuda")
    probe = {}

    def first_leaf(leaf_id, name, info):
        if name == "l0.w" and not probe:
            probe.update(clone_info(info), leaf_id=leaf_id)

    sim.leaf_hook = first_leaf
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    main_counts = ops.launch_counts()
    t2 = res.ledger.totals("paper")
    print(f"[main] table2_quick on {kind}: rounds={cfg.rounds} "
          f"launches={main_counts} upload_vs_dense(paper)="
          f"{t2['upload_vs_dense']:.6f} (tpu "
          f"{res.ledger.totals('tpu')['upload_vs_dense']:.6f}) "
          f"final_acc={res.final_acc:.4f} accs={res.accuracies} "
          f"wall_s={res.wall_s:.4f} round_s={res.wall_s / cfg.rounds:.4f}",
          flush=True)
    for name in ("stream_scatter_add", "pair_mask_streams"):
        check(main_counts[name] > 0, f"main path never launched {name}")
    check(main_counts["pair_mask_streams"] == cfg.rounds,
          f"table2_quick launched pair_mask_streams "
          f"{main_counts['pair_mask_streams']} times, expected one a round "
          f"({cfg.rounds})")
    check(abs(t2["upload_vs_dense"] - 0.091) <= 0.005,
          f"upload_vs_dense {t2['upload_vs_dense']:.4f} outside 9.1% +- 0.5")
    check(res.final_acc >= 0.98, f"final_acc {res.final_acc:.4f} < 0.98")
    check(all(torch.isfinite(p).all() for p in sim.state.params.values()),
          "non-finite parameters after table2_quick")
    # round 0's l0.w encode + decode, replayed on the CPU from the same
    # inputs with the plain versions: streams, residuals and the decoded sum
    # are bit-equal to what the card computed
    from repro_torch.core import streams as se

    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in probe.items()}
    size = cpu["size"]
    st, nr = se.encode_leaf_batch(
        cpu["updates"], cpu["residuals"], k=cpu["k"], nb=1, m=size,
        size=size, pair_seeds=cpu["pair_seeds"], pair_signs=cpu["pair_signs"],
        k_mask=cpu["k_mask"], mask_p=-1.0, mask_q=2.0, leaf_id=cpu["leaf_id"],
        weights=cpu["weights"])
    dense = se.decode_leaf_batch(st, nb=1, m=size, size=size,
                                 k_mask=cpu["k_mask"])
    same = (bits_equal(st.indices, probe["streams"].indices.cpu())
            and bits_equal(st.values, probe["streams"].values.cpu())
            and bits_equal(nr, cpu["new_residuals"])
            and bits_equal(dense, cpu["dense"]))
    print(f"[main] round 0 leaf l0.w (k={cpu['k']} k_mask={cpu['k_mask']} "
          f"slots={st.indices.numel()}) replayed on the CPU: streams, "
          f"residuals and decoded sum bit-equal={same}", flush=True)
    check(same, "the card's round-0 l0.w encode/decode differs from the "
          "CPU replay")

    # ------------------------------------------------------- 4. recovery
    cfg = presets.get("secagg_quick").replace(out_json=None)
    sim = Simulation(cfg, device="cuda")
    n_leaves = len(sim.model.leaf_names())
    per_round, captured = [], {}

    def leaf_hook(leaf_id, name, info):
        if info["dropped"] and name == "l0.w" and "info" not in captured:
            captured["info"] = clone_info(info)

    def round_hook(r, info):
        per_round.append((r, list(info["dropped"]), ops.launch_counts()))

    sim.leaf_hook = leaf_hook
    ops.reset_launch_counts()
    res = sim.run(hooks=[round_hook])
    prev = {k: 0 for k in ops.KERNELS}
    dropped_rounds = 0
    for r, dropped, counts in per_round:
        pm = counts["pair_mask_streams"] - prev["pair_mask_streams"]
        dropped_rounds += bool(dropped)
        want = 2 if dropped else 1
        check(pm == want,
              f"round {r}: launched pair_mask_streams {pm} times for "
              f"{n_leaves} leaves, expected {want} (the masks of every "
              f"leaf{', then every recovery stream' if dropped else ''})")
        prev = counts
    check(dropped_rounds > 0, "secagg_quick dropped no client")
    check("info" in captured, "no dropout round reached the leaf hook")
    info = captured["info"]
    want = plain_unmasked_sum(info)
    got = info["dense"].cpu()
    err = (got - want).abs().max().item()
    tol = 64 * 2.0 ** -24
    print(f"[recovery] secagg_quick: {dropped_rounds} dropout round(s), "
          f"dropped={info['dropped']} launches={ops.launch_counts()} "
          f"decoded vs plain unmasked sum max abs err {err:.3e} "
          f"(tolerance 64 * 2^-24 = {tol:.3e}) final_acc={res.final_acc:.4f}",
          flush=True)
    check(err <= tol, f"recovered aggregate off by {err:.3e}")

    # ------------------------------------------------- 5. full-size model
    cfg = vgg16_table2()
    sim = Simulation(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = sim.run()
    vgg_counts = ops.launch_counts()
    finite = all(torch.isfinite(p).all() for p in sim.state.params.values())
    print(f"[vgg16] cifar_vgg16 table2 protocol: rounds={cfg.rounds} "
          f"params={sim.model.n_params()} launches={vgg_counts} "
          f"wall_s={res.wall_s:.4f} accs={res.accuracies} "
          f"upload_vs_dense(paper)="
          f"{res.ledger.totals('paper')['upload_vs_dense']:.6f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"finite={finite}", flush=True)
    check(finite, "non-finite VGG16 parameters")
    for name in ("stream_scatter_add", "pair_mask_streams"):
        check(vgg_counts[name] > 0, f"VGG16 rounds never launched {name}")
    check(vgg_counts["pair_mask_streams"] == cfg.rounds,
          f"VGG16 launched pair_mask_streams "
          f"{vgg_counts['pair_mask_streams']} times for "
          f"{len(sim.model.leaf_names())} leaves, expected one a round")

    # --------------------------------------------------------- 6. codecs
    codec_counts = codec_phase(kind)

    # ------------------------------------------------------------- 7. DP
    dp_phase(kind)

    # ---------------------------------------------------- 8-9. tree, async
    t_phase = time.perf_counter()
    tree_phase(kind)
    async_phase(kind)
    print(f"[async] phases 8-9 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # --------------------------------------------------------- 10. flash
    t_phase = time.perf_counter()
    rows["flash_attention"] = flash_phase(device)

    # ------------------------------------------------------------ 11. LM
    lm_counts = lm_phase(kind, card, rows["flash_attention"][0]["ms"])
    print(f"[lm] phases 10-11 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ------------------------------------------------------ 16. families
    family_counts = families_phase(card)

    # ------------------------------------------------ 12-13. resume, serve
    t_phase = time.perf_counter()
    resume_phase(kind)
    serve_phase(kind)
    print(f"[serve] phases 12-13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ------------------------------------------------------- 14. sharded
    sharded_counts, row_rows = sharded_phase(kind, card, device)
    rows["pair_mask_streams"] += row_rows

    # --------------------------------------------------------- 15. bench
    bench_phase(kind, card)

    # ------------------------------------------------------------ report
    sources = {"stream_scatter_add": ("src/repro_torch/kernels/csrc/"
                                      "stream_scatter_add.cu",
                                      "src/repro/kernels/stream_decode.py:57"),
               "pair_mask_streams": ("src/repro_torch/kernels/csrc/"
                                     "pair_mask_streams.cu",
                                     "src/repro/kernels/mask_prng.py:97"),
               "bitpack_rows": ("src/repro_torch/kernels/csrc/bitpack.cu",
                                "src/repro/kernels/pack.py:42"),
               "bitunpack_rows": ("src/repro_torch/kernels/csrc/bitpack.cu",
                                  "src/repro/kernels/pack.py:65"),
               "flash_attention": ("src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:77"),
               "thgs_sparsify": ("src/repro_torch/kernels/csrc/"
                                 "thgs_sparsify.cu",
                                 "src/repro/kernels/thgs_sparsify.py:29"),
               "mask_prng_apply": ("src/repro_torch/kernels/csrc/"
                                   "pair_mask_streams.cu",
                                   "src/repro/kernels/mask_prng.py:38")}
    # each kernel's launches come from the path that runs it: table2_quick
    # and the sharded parity runs for the scatter and the masks,
    # codec_sweep_quick and its sharded int8 arm for the bit packing, the
    # served Yi-6B and the families' first prefills for the flash
    # attention; no reference path calls the THGS split or the dense mask
    # apply, whose path is the public ops API (the [kernels] phase's ops
    # path over every leaf of two models)
    launches = {**main_counts,
                **{n: main_counts[n] + sharded_counts[n]
                   for n in ("stream_scatter_add", "pair_mask_streams")},
                **{n: codec_counts[n] + sharded_counts[n]
                   for n in ("bitpack_rows", "bitunpack_rows")},
                "flash_attention": (lm_counts["flash_attention"]
                                    + family_counts["flash_attention"]),
                "thgs_sparsify": split_counts["thgs_sparsify"],
                "mask_prng_apply": split_counts["mask_prng_apply"]}
    notes = {name: "no reference path calls this kernel: launches are the "
             "[kernels] phase's ops path over every leaf of mnist_mlp and "
             "cifar_vgg16" for name in ("thgs_sparsify", "mask_prng_apply")}
    kernels = []
    for name in ops.KERNELS:
        main_row = rows[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            **({"note": notes[name]} if name in notes else {}),
            "shapes": rows[name]})
    print(f"[done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
