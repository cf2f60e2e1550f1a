"""Cohort-scaling benchmarks (suite key ``cohort`` -> BENCH_torch_cohort.json;
port of ``repro.bench.cohort_bench``).

Clients/s of the server aggregation data plane vs cohort size, flat vs tree
(DESIGN.md §13): for each cohort C in {64, 256, 1024} the suite synthesizes
one round's sparse streams directly (in-range indices and normal values from
a seeded ``torch.Generator`` — this isolates the decode, no SGD and no mask
PRNG in the timed region) and times

  * ``flat`` — the single scatter launch (``streams.decode_sum_blocks``);
  * ``tree`` — G = ~sqrt(C) sub-aggregators, one scatter launch each over
    its contiguous index range, combined by concatenation
    (``streams.decode_sum_tree``) — bit-equal to flat, so the delta is
    pure execution cost.

An info entry per cohort reports the collective-volume story: the flat
all-gather moves C·k stream slots to every device, the tree's inter-group
combine moves G dense partials totalling one model (O(m)).

Quick and full mode run the SAME cohort sizes, with quick shrinking the leaf
and rep count. All entries are min-of-reps (``timing.measure``).
"""
from __future__ import annotations

import torch

from repro_torch.bench.timing import entry, measure, sync
from repro_torch.core import streams
from repro_torch.launch.mesh import default_tree_groups

COHORTS = (64, 256, 1024)


def leaf(quick: bool) -> tuple[int, int, int]:
    """``(size, k, reps)``: the leaf, each client's slots and the reps."""
    size, reps = (1 << 12, 3) if quick else (1 << 16, 5)
    return size, max(1, size // 256), reps


def cohort_streams(n_clients: int, size: int, k: int,
                   device) -> streams.StreamBatch:
    """One round's synthetic streams, ``[n_clients, 1, k]``, from a
    generator seeded with the cohort size."""
    gen = torch.Generator().manual_seed(n_clients)
    idx = torch.randint(0, size, (n_clients, 1, k), generator=gen,
                        dtype=torch.int32)
    vals = torch.randn((n_clients, 1, k), generator=gen)
    return streams.StreamBatch(indices=idx.to(device),
                               values=vals.to(device))


def _one_cohort(n_clients: int, size: int, k: int, reps: int,
                device) -> list[dict]:
    st = cohort_streams(n_clients, size, k, device)
    groups = default_tree_groups(n_clients)
    splits = streams.tree_splits(size, groups)

    def flat():
        out = streams.decode_sum_blocks(st, 1, size)
        sync(device)
        return out

    def tree():
        out = streams.decode_sum_tree(st, 1, size, splits=splits)
        sync(device)
        return out

    # parity guard: a benchmark of a wrong decode is worse than no benchmark
    if not torch.equal(flat(), tree()):
        raise AssertionError("tree decode diverged from flat")

    us_flat = measure(flat, reps)
    us_tree = measure(tree, reps)
    stream_mb = n_clients * k * 8 / 1e6        # int32 idx + f32 val per slot
    partial_mb = size * 4 / 1e6                # G partials totalling one model
    tag = f"c{n_clients}_n{size}"
    return [
        entry(f"cohort/flat_{tag}", us_flat,
              f"{n_clients / (us_flat / 1e6):.0f}_clients_per_s", reps=reps),
        entry(f"cohort/tree_{tag}_g{groups}", us_tree,
              f"{n_clients / (us_tree / 1e6):.0f}_clients_per_s", reps=reps),
        entry(f"cohort/volume_{tag}", 0.0,
              f"gather{stream_mb:.2f}MB_vs_combine{partial_mb:.2f}MB"),
    ]


def entries(quick: bool = False, device="cuda") -> list[dict]:
    size, k, reps = leaf(quick)
    out = []
    for C in COHORTS:
        out += _one_cohort(C, size, k, reps, torch.device(device))
    return out

