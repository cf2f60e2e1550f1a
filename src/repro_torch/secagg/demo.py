"""Secure-aggregation walkthrough: what the server sees, and why masks
cancel (port of ``examples/secure_aggregation_demo.py``).

Reproduces the paper's §4 safety analysis empirically on the batched stream
engine (``core/streams.py``) driven by the ``secagg`` round protocol: three
banks run the Bonawitz phase sequence (DH key agreement, Shamir key sharing,
masked upload, unmasking); the walkthrough shows (1) the round protocol's
set-up, (2) the server's view of each individual update is masked at the
mask-support positions, (3) the aggregate is exact, (4) when a bank drops
mid-round the server reconstructs its DH key from the survivors' Shamir
shares and cancels the unpaired masks, and (5) the dense Bonawitz baseline
costs the full vector while the sparse scheme moves only top-k ∪
mask-support plus a few control-plane shares.

The sizes and seeds are the reference's: n = 4096, k = 2% of n,
``SecureAggConfig(mask_ratio=0.02, seed=2024)``, banks 0-2, gradients
``jax.random.normal(fold_in(key(7), b), (n,))`` drawn bit for bit by
``core/threefry.normal`` on the host. On the card the encode launches the
pair-mask kernel and each of the three decodes launches the scatter kernel
(the recovery decode the pair-mask kernel again, for the recovery masks).

Run:  PYTHONPATH=src python -m repro_torch.secagg.demo [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given, and raises on a
machine without one. :func:`run` returns the facts as a dict.
"""
from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import streams, threefry
from repro_torch.core.costs import PAPER_BITS
from repro_torch.core.masks import dh_agree
from repro_torch.core.types import SecureAggConfig
from repro_torch.kernels import ops
from repro_torch.secagg import RoundProtocol

N = 4096
BANKS = (0, 1, 2)
SA = SecureAggConfig(mask_ratio=0.02, seed=2024)
GRAD_SEED = 7


def gradients(n: int = N, banks: Sequence[int] = BANKS) -> torch.Tensor:
    """The banks' gradients, ``f32[C, n]`` on the host: the reference's
    ``jax.random.normal(fold_in(key(7), b), (n,))``, bit for bit."""
    key = threefry.key(GRAD_SEED)
    return torch.stack([threefry.normal(threefry.fold_in(key, b), (n,))
                        for b in banks])


def run(device: str = "cuda") -> dict:
    """The walkthrough on ``device``: its five facts, the streams and the
    three decoded sums (on the host), and the kernel launches it made."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch versions of the kernels")
    before = ops.launch_counts()
    n, sa, banks = N, SA, list(BANKS)
    k = int(n * 0.02)
    C = len(banks)
    k_mask = sa.k_mask_for(n, C)
    proto = RoundProtocol.setup(sa, banks, round_t=0)

    grads = gradients(n, banks).to(device)
    residuals = torch.zeros_like(grads)
    pair_seeds, pair_signs = proto.pair_seed_matrix()
    # one encode for every bank: top-k ∪ mask-support streams, all pair
    # masks from one pair-mask launch
    st, new_res = streams.encode_leaf_batch(
        grads, residuals, k=k, nb=1, m=n, size=n,
        pair_seeds=pair_seeds, pair_signs=pair_signs, k_mask=k_mask,
        mask_p=sa.p, mask_q=sa.q, leaf_id=0)

    idx0 = st.indices[0, 0].cpu().numpy()
    sent = st.values[0, 0].cpu().numpy()
    raw = grads[0].cpu().numpy()[idx0]
    masked_slots = int((np.abs(sent - raw) > 1e-6).sum())

    # one scatter-add decodes the whole round; masks cancel exactly
    dense = streams.decode_leaf_batch(st, nb=1, m=n, size=n)
    expected = (grads - new_res).sum(0)
    err = float(torch.max(torch.abs(dense - expected)))

    # bank2 drops after mask agreement: the survivors hand the server their
    # Shamir shares of bank2's key; the server reconstructs it, re-derives
    # the pair seeds and subtracts the unpaired masks (Bonawitz recovery)
    alive = torch.tensor([True, True, False], device=device)
    recovered_seeds = proto.recover_seeds(survivors=[0, 1], dropped=[2])
    dense_drop = streams.decode_leaf_batch(
        st, nb=1, m=n, size=n, alive=alive,
        pair_seeds=recovered_seeds, pair_signs=pair_signs, k_mask=k_mask,
        mask_p=sa.p, mask_q=sa.q, leaf_id=0)
    expected_drop = ((grads - new_res) * alive[:, None]).sum(0)
    err_drop = float(torch.max(torch.abs(dense_drop - expected_drop)))
    dense_plain = streams.decode_leaf_batch(st, nb=1, m=n, size=n,
                                            alive=alive)
    no_recovery = float(torch.max(torch.abs(dense_plain - expected_drop)))

    # wire payload: the gated self-pair slot (zero value, duplicated index)
    # is not transmitted -> k + (C-1)*k_mask slots per client (Eq. 6). All
    # three arms are whole-cohort uploads for the round (C banks'
    # gradients, all C·(C-1) phase-1 shares plus the recovery shares
    # bank2's drop just cost) so the ratio compares like scopes.
    k_wire = st.indices.shape[-1] - k_mask
    sparse_bits = C * PAPER_BITS.sparse_bits(k_wire)
    share_bits = ((proto.n_phase1_shares + proto.n_recovery_shares(1))
                  * PAPER_BITS.share_bits())
    dense_bits = C * PAPER_BITS.dense_bits(n)
    after = ops.launch_counts()
    return {
        "n": n, "k": k, "k_mask": k_mask,
        "dh_secret": dh_agree(sa.seed, 0, 1),
        "dh_secret_other": dh_agree(sa.seed, 1, 0),
        "t": proto.t, "n_phase1_shares": proto.n_phase1_shares,
        "slots": int(idx0.shape[0]), "first_values": sent[:5].copy(),
        "masked_slots": masked_slots,
        "clear_slots": int(idx0.shape[0]) - masked_slots,
        "exact_err": err, "no_recovery_err": no_recovery,
        "recovered_err": err_drop,
        "n_recovery_shares": proto.n_recovery_shares(1),
        "sparse_bytes": sparse_bits / 8, "share_bytes": share_bits / 8,
        "dense_bytes": dense_bits / 8,
        "reduction": dense_bits / (sparse_bits + share_bits),
        "indices": st.indices.cpu(), "values": st.values.cpu(),
        "dense": dense.cpu(), "dense_drop": dense_drop.cpu(),
        "dense_no_recovery": dense_plain.cpu(),
        "launches": {name: after[name] - before[name] for name in after},
    }


def report(f: dict) -> str:
    """The reference's printout of the facts, line for line."""
    n = f["n"]
    return "\n".join([
        "1. round protocol setup (control plane):",
        f"   DH: bank0<->bank1 shared secret {f['dh_secret']:#x} "
        f"(== {f['dh_secret_other']:#x} from the other side)",
        f"   Shamir: each bank splits its key into {len(BANKS)} shares, "
        f"threshold t={f['t']} ({f['n_phase1_shares']} shares cross "
        f"the wire)\n",
        "2. what the SERVER sees from bank0 (one leaf):",
        f"   {f['slots']} slots of {n} ({f['slots']/n:.1%}); "
        f"first 5 values: {f['first_values'].round(3)}",
        f"   {f['masked_slots']} slots differ from the raw gradient "
        f"(mask-protected); {f['clear_slots']} top-k slots are "
        f"clear (paper §4 case 1 — sparsity itself is the cover)\n",
        f"3. aggregate exactness: max |masked_sum - true_sparse_sum| = "
        f"{f['exact_err']:.2e}",
        f"4. bank2 drops: survivor sum error {f['no_recovery_err']:.2f} "
        f"without recovery -> {f['recovered_err']:.2e} after reconstructing "
        f"its key from {f['n_recovery_shares']} survivor shares",
        f"\n5. communication: sparse+masked = {f['sparse_bytes']:.0f} B "
        f"(+ {f['share_bytes']:.0f} B Shamir shares), "
        f"dense Bonawitz = {f['dense_bytes']:.0f} B "
        f"-> {f['reduction']:.1f}x reduction",
    ])


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.secagg.demo",
        description="secure-aggregation walkthrough on the port")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(report(run(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
