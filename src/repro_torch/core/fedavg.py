"""Federated optimization: FedAvg / FedProx clients + THGS/secure-agg server
(port of ``repro.core.fedavg``: the synchronous round, flat or tree, serial
or client-sharded, and the async buffered update).

A round is:
  1. ``batched_client_update`` — local SGD for every participant,
     ``torch.func.vmap`` of the loss over the stacked client batches and
     one stacked copy of the parameters per client (one
     batched program, as the reference's ``jax.vmap``; the async update
     runs the same program), differentiated by autograd. The conv models'
     convolutions and batch norms run one client at a time inside it
     (``paper_models.per_client``), backward included, so a client's bits
     do not depend on how many clients share the call: a sharded round is
     the serial one bit for bit, as the reference's (DESIGN.md §11);
  2. ``streams.encode_leaf_batch`` per leaf — the unified top-k ∪
     mask-support encode for all clients. The pair masks of every leaf
     come first, from ONE ``pair_mask_streams`` launch a round
     (``streams.mask_streams_round``; counter-based pair seeds from the
     secagg round protocol, copied to the card once);
  3. ``streams.decode_leaf_batch`` per leaf — one ``stream_scatter_add``
     launch over every client's stream, survivor gating, and Bonawitz
     reconstruction of dropped clients' unpaired masks (in a dropout round
     a second ``pair_mask_streams`` launch makes every leaf's recovery
     streams: ``streams.recovery_streams_round``). With
     ``topology='tree'`` it is ``streams.decode_leaf_tree``: one launch per
     sub-aggregator's index range, bit-equal to the flat decode.

With ``mesh`` (``launch/mesh.ClientsMesh``) the round is client-parallel
(DESIGN.md §11): ``batched_client_update_sharded`` runs each shard's local
SGD on its device, each shard encodes its clients (one pair-mask row launch
a round), one gather brings the wire payload to the state's device, the
decode runs once there, and the residuals come back to it; the state stays
where it was.

Each stage runs under a ``torch.profiler.record_function`` span
(``round.local_sgd``, ``round.secagg_setup``, ``round.encode``,
``round.decode``, and in a sharded round ``round.gather``), which ``python -m repro_torch.sim.profile`` reads; a span
costs about a microsecond when no profiler is active.

With a non-f32 ``codec`` the encode also quantizes and packs each leaf's
streams (one ``bitpack_rows`` and one ``bitunpack_rows`` launch a leaf,
each over both wire streams);
with an active ``dp`` each client's accumulator is clipped before the
encode and the streams carry grid-rounded noise on a public support
(``core/dp.py``).

Parameters are ``{name: tensor}`` dicts in the reference's leaf order
(``PaperModel.leaf_names``); the leaf's position is its ``leaf_id``.
Weighted aggregation is client-side; the server divides by the survivors'
total weight after the masks cancelled.

``run_async_update`` is one FedBuff-style buffered server step: every report
trains from its own stale parameter version (``torch.func.vmap`` over params
and batches) and joins the aggregate with weight ``(1 + tau)^-1/2``; with
every tau 0 it is ``run_round`` without secure aggregation, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.profiler import record_function

from repro_torch.core import costs, schedules
from repro_torch.core import streams as se
from repro_torch.core.codecs import reject_codec_with_masks
from repro_torch.core.dp import (DPConfig, clip_client_updates,
                                 reject_codec_with_noise)
from repro_torch.core.types import (CommRecord, FedConfig, SecureAggConfig,
                                    THGSConfig)

Params = dict[str, torch.Tensor]
LossFn = Callable[[Mapping[str, torch.Tensor], Any], torch.Tensor]


def _prox_grads(p: Params, params: Params, prox_mu: float) -> Params:
    """FedProx's gradient of ``mu/2 ||p - params||^2`` at ``p``."""
    def prox_term(p):
        sq = sum(torch.sum((p[n] - params[n]) ** 2) for n in params)
        return 0.5 * prox_mu * sq

    return torch.func.grad(prox_term)(p)


def _client_update(params: Params, batches, loss_fn: LossFn,
                   local_steps: int, lr: float,
                   prox_mu: float = 0.0) -> tuple[Params, torch.Tensor]:
    """Local SGD (optionally FedProx-proximal) over ``batches = (x, y)``
    stacked on a leading ``local_steps`` axis; returns (delta, mean loss)."""
    grad_fn = torch.func.grad_and_value(loss_fn)
    p = dict(params)
    losses = []
    for s in range(local_steps):
        g, loss = grad_fn(p, tuple(b[s] for b in batches))
        if prox_mu != 0.0:
            gp = _prox_grads(p, params, prox_mu)
            g = {n: g[n] + gp[n] for n in g}
        p = {n: p[n] - lr * g[n] for n in p}
        losses.append(loss)
    delta = {n: p[n] - params[n] for n in params}
    return delta, torch.stack(losses).mean()


def client_update(params: Params, batches, loss_fn: LossFn,
                  local_steps: int, lr: float,
                  prox_mu: float = 0.0) -> tuple[Params, torch.Tensor]:
    """Single-client entry (for callers that step one client at a time):
    local SGD over ``batches = (x[steps, B, ...], y[steps, B])``; returns
    (delta, mean loss)."""
    return _client_update(params, batches, loss_fn, local_steps, lr,
                          prox_mu)


def batched_client_update(params: Params, batches_stacked, loss_fn: LossFn,
                          local_steps: int, lr: float,
                          prox_mu: float = 0.0) -> tuple[Params, torch.Tensor]:
    """All participants' local SGD in one vmapped program, every client
    from ``params``.

    ``batches_stacked = (x[C, steps, B, ...], y[C, steps, B])``. Returns
    (deltas stacked ``{name: [C, ...]}``, losses [C]). The parameters are
    stacked, one copy per client, and run through
    :func:`batched_client_update_multi`: a synchronous round and an async
    update whose reports all trained from one version are then the same
    program, bit-equal on every device. (Broadcast parameters would lower
    the first step's products to one matmul and stacked ones to a batched
    matmul, which cuBLAS rounds differently.)"""
    C = batches_stacked[0].shape[0]
    stacked = {n: torch.stack([p] * C) for n, p in params.items()}
    return batched_client_update_multi(stacked, batches_stacked, loss_fn,
                                       local_steps, lr, prox_mu)


def batched_client_update_multi(params_stacked: Params, batches_stacked,
                                loss_fn: LossFn, local_steps: int, lr: float,
                                prox_mu: float = 0.0
                                ) -> tuple[Params, torch.Tensor]:
    """Every report's local SGD from its own parameters: params vmapped
    beside the batches (``{name: [B, ...]}`` and ``(x[B, steps, ...],
    y[B, steps, ...])``; the async update's reports are stale versions).
    Returns (deltas ``{name: [B, ...]}``, losses [B]).

    :func:`_client_update` for every client at once: autograd
    differentiates the vmapped forward, the clients' losses summed with
    weight 1, so each client's gradient is its own loss's. The backward of
    an op that runs one client at a time under ``vmap``
    (``paper_models.per_client``: the conv models' convolutions and batch
    norms) then runs per client too, where ``torch.func.grad`` inside
    ``vmap`` would batch it; for every other op the two give the same
    bits (the MLPs: ``tests/test_torch_client_shape.py``, ``chip_smoke.py``
    ``[sharded]``)."""
    vloss = torch.func.vmap(loss_fn, randomness="error")
    p = dict(params_stacked)
    losses = []
    for s in range(local_steps):
        with torch.enable_grad():
            leaves = {n: x.detach().requires_grad_() for n, x in p.items()}
            loss = vloss(leaves, tuple(b[:, s] for b in batches_stacked))
            g = dict(zip(leaves, torch.autograd.grad(
                loss.sum(), list(leaves.values()))))
        if prox_mu != 0.0:
            gp = torch.func.vmap(lambda q, q0: _prox_grads(q, q0, prox_mu))(
                p, params_stacked)
            g = {n: g[n] + gp[n] for n in g}
        p = {n: p[n] - lr * g[n] for n in p}
        losses.append(loss.detach())
    delta = {n: p[n] - params_stacked[n] for n in params_stacked}
    return delta, torch.stack(losses, 1).mean(1)


def batched_client_update_sharded(mesh, params: Params, batches_stacked,
                                  loss_fn: LossFn, local_steps: int,
                                  lr: float, prox_mu: float = 0.0, *,
                                  device=None, pad_one: bool = True
                                  ) -> tuple[list, torch.Tensor]:
    """Client-parallel local SGD: the cohort split over the ``clients``
    mesh (``launch/mesh.py``), each shard running the unchanged
    :func:`batched_client_update` on its clients and its device.

    ``batches_stacked = (x[C, steps, B, ...], y[C, steps, B])``, split
    here over the shards. Returns (one deltas dict
    ``{name: [C_loc, ...]}`` per shard, on the shard's device; the losses
    ``[C]`` gathered in client order onto ``device``, default the params'
    device). A client's bits do not depend on how many clients share a
    call (module docstring), so the deltas are bit-equal to the serial
    program's. With ``pad_one`` a one-client shard runs as two rows and
    keeps the first: ATen computes a batch of ONE matrix product
    unbatched, which sums in another order, on the CPU and on the card
    alike (PERF.md §6 has the readings and the cost)."""
    device = device if device is not None else \
        next(iter(params.values())).device
    C = batches_stacked[0].shape[0]
    on_device = {}

    def body(i0, dev, batches):
        if dev not in on_device:
            on_device[dev] = {n: x.to(dev) for n, x in params.items()}
        c_loc = batches[0].shape[0]
        if c_loc == 1 and pad_one:
            batches = tuple(torch.cat([b, b]) for b in batches)
        deltas, losses = batched_client_update(
            on_device[dev], batches, loss_fn, local_steps, lr, prox_mu)
        return {n: d[:c_loc] for n, d in deltas.items()}, losses[:c_loc]

    out = se.shard_map_clients(body, mesh, C, se.shard_client_tree(
        tuple(batches_stacked), mesh))
    return ([o[0] for o in out],
            se.all_gather_round([o[1] for o in out], device))


@dataclasses.dataclass
class FederatedState:
    params: Params
    residuals: dict[int, Params]        # per-client error feedback
    losses: dict[int, float]            # last local loss per client (Eq. 2)
    round: int = 0
    comm_log: list[CommRecord] = dataclasses.field(default_factory=list)


def init_state(params: Params, fed: FedConfig) -> FederatedState:
    return FederatedState(
        params=dict(params),
        residuals={c: {n: torch.zeros_like(x) for n, x in params.items()}
                   for c in range(fed.n_clients)},
        losses={},
    )


def _mean_or_none(vals):
    vals = [v for v in vals if v is not None]
    return float(sum(vals) / len(vals)) if vals else None


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true f32 division on every device (a CUDA tensor
    divided by a Python scalar is multiplied by the reciprocal instead)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _check_topology(topology: str, thgs) -> None:
    if topology not in ("flat", "tree"):
        raise ValueError(f"unknown topology {topology!r}")
    if topology == "tree" and thgs is None:
        raise ValueError("topology='tree' requires THGS sparse streams; "
                         "dense rounds have no stream decode to shard")


def _decode(streams_b, size: int, splits, **kw) -> torch.Tensor:
    """The flat decode, or the tree decode over ``splits`` (not None)."""
    if splits is not None:
        return se.decode_leaf_tree(streams_b, nb=1, m=size, size=size,
                                   splits=splits, **kw)
    return se.decode_leaf_batch(streams_b, nb=1, m=size, size=size, **kw)


def run_round(
    state: FederatedState,
    client_batches: dict[int, Any],
    loss_fn: LossFn,
    fed: FedConfig,
    thgs: THGSConfig | None,
    sa: SecureAggConfig,
    bits: costs.BitModel = costs.PAPER_BITS,
    client_weights: Mapping[int, float] | None = None,
    dropped: Sequence[int] = (),
    leaf_hook: Callable[[int, str, dict], None] | None = None,
    codec: str = "f32",
    dp: DPConfig | None = None,
    topology: str = "flat",
    tree_groups: int = 0,
    mesh=None,
) -> FederatedState:
    """One synchronous aggregation round over the given participants.

    ``thgs=None`` runs the dense FedAvg/FedProx baseline, or with
    ``sa.enabled`` dense secure aggregation (full-size pair masks,
    ``secure_agg.dense_masked_update``). ``thgs.selector`` picks each
    leaf's top-k ('exact', 'sampled' or 'local').
    ``client_weights`` gives per-client aggregation weights (default 1).
    ``dropped`` lists participants that agreed on masks but whose upload
    never arrived: their streams are excluded and the survivors' unpaired
    masks are regenerated from Shamir-reconstructed seeds and cancelled
    (raises ``secagg.ThresholdError`` below the threshold).
    ``codec`` selects the stream wire (``core/codecs.py``): a quantized
    codec needs THGS and is rejected under secure aggregation.
    ``dp`` (``core/dp.DPConfig``) clips each client's accumulator
    ``residual + delta`` to ``dp.clip`` and, with ``sigma > 0``, releases
    noised values on the round's public support; it needs THGS, the f32
    codec and uniform client weights. ``None`` or an inactive config leaves
    the round bit-identical to a round without DP.
    ``topology='tree'`` decodes each leaf over ``tree_groups``
    sub-aggregators (0: ``max(2, round(sqrt(C)))``), each owning a
    contiguous index range; bit-equal to ``'flat'``. It needs THGS.
    ``leaf_hook(leaf_id, name, info)``
    is called after each leaf's decode with the leaf's encode inputs, its
    streams, its decoded sum and its new residuals before the dropped
    clients' carry, on the serial and the sharded round alike (a probe for
    tests and smoke checks; None costs nothing).
    ``mesh`` (``launch/mesh.ClientsMesh``) runs the round client-parallel
    when ``streams.can_shard_clients(mesh, C)``: each shard's local SGD and
    encode (its rows of the pair masks in one launch a round) on its
    device, one gather of the wire payload, and the decode once, on the
    state's device, over the gathered stream; the residuals come back to
    the state's device. Bit-equal to the serial round where the shards'
    batched products round as the cohort's do (DESIGN.md §11). A mesh that
    cannot shard the cohort runs the serial round.
    """
    _check_topology(topology, thgs)
    dp_active = dp is not None and dp.active
    if dp_active:
        dp.validate()
        if thgs is None:
            raise ValueError(
                "dp requires THGS sparse streams; the DP noise rides the "
                "unified stream's transmitted slots (thgs is None)")
        reject_codec_with_noise(codec, dp.sigma)
        if client_weights and any(
                float(w) != 1.0 for w in client_weights.values()):
            raise ValueError(
                "dp requires uniform client weights: weights scale the "
                "stream values before masking, so a weight != 1.0 would "
                "scale that client's contribution past the clip bound S "
                "the accountant calibrates noise against")
    participants = sorted(client_batches.keys())
    C = len(participants)
    sharded = se.can_shard_clients(mesh, C)
    dropped = set(dropped)
    assert dropped <= set(participants), "dropped must be participants"
    survivors = [c for c in participants if c not in dropped]
    assert survivors, "a round needs at least one surviving client"
    names = list(state.params)
    dev = state.params[names[0]].device
    alive = torch.tensor([c not in dropped for c in participants],
                         device=dev)
    w_list = [float(client_weights.get(c, 1.0)) if client_weights else 1.0
              for c in participants]
    w_vec = torch.tensor(w_list, dtype=torch.float32, device=dev)
    w_surv_total = sum(w for w, c in zip(w_list, participants)
                       if c not in dropped)
    sizes = [state.params[n].numel() for n in names]
    model_size = sum(sizes)

    # ---- 1. all clients' local SGD, one vmapped program ----
    batches_stacked = tuple(
        torch.stack([client_batches[c][i] for c in participants])
        for i in range(len(client_batches[participants[0]])))
    prox_mu = fed.prox_mu if fed.algorithm == "fedprox" else 0.0
    with record_function("round.local_sgd"):
        if sharded:
            # per shard [C_loc, ...] on its device; losses gathered in
            # client order (they feed Eq. 2's beta)
            delta_shards, losses = batched_client_update_sharded(
                mesh, state.params, batches_stacked, loss_fn,
                fed.local_steps, fed.local_lr, prox_mu, device=dev)
            deltas = None
        else:
            deltas, losses = batched_client_update(
                state.params, batches_stacked, loss_fn, fed.local_steps,
                fed.local_lr, prox_mu)
        losses_list = [float(x) for x in losses.tolist()]
    if sharded and thgs is None:
        with record_function("round.gather"):
            deltas = se.all_gather_round(delta_shards, dev)

    if thgs is not None:
        # per-(round, client) noise seeds and the round's public support
        # seed, derived host-side from config + round alone
        dp_sigma_c = dp.sigma_client(C) if dp_active else 0.0
        dp_noised = dp_active and dp.noised
        dp_seeds = (torch.from_numpy(
            dp.client_seeds(state.round, participants).astype("int64"))
            .to(dev) if dp_noised else None)
        dp_sup_seed = int(dp.support_seed(state.round)) if dp_noised else 0
        # Eq. 2's beta from the federation-mean loss trajectory: one per-leaf
        # k for the whole batched round
        loss_prev = _mean_or_none([state.losses.get(c) for c in participants])
        loss_curr = _mean_or_none(losses_list)
        ks = schedules.leaf_ks(thgs, sizes, t=state.round,
                               total_rounds=fed.rounds, loss_prev=loss_prev,
                               loss_curr=loss_curr)
        use_masks = sa.enabled and C >= 2
        reject_codec_with_masks(codec, use_masks)
        if use_masks:
            with record_function("round.secagg_setup"):
                # secagg sits beside core: this local import is the one
                # upward edge (the reference's layering, DESIGN.md §10)
                from repro_torch.secagg.protocol import RoundProtocol

                proto = RoundProtocol.setup(sa, participants, state.round)
                pair_seeds, pair_signs = proto.pair_seed_matrix()
                recovery_seeds = (
                    proto.recover_seeds(survivors, sorted(dropped))
                    if dropped else None)
        else:
            proto = None
            pair_seeds = pair_signs = recovery_seeds = None

        res_st = {n: torch.stack([state.residuals[c][n]
                                  for c in participants]) for n in names}
        if dp_active and dp.clips:
            # clip the ENCODER INPUT, the accumulator residual + delta, so
            # the bound S holds for the full stream a client emits; the
            # clipped accumulator becomes the encode's update over a zeroed
            # residual (compliant clients scale by exactly 1.0). A sharded
            # round clips the stacked cohort too, then splits it again: the
            # norm's reduction runs at the serial round's shape
            if sharded:
                with record_function("round.gather"):
                    deltas = se.all_gather_round(delta_shards, dev)
            deltas = clip_client_updates(
                {n: deltas[n].to(torch.float32) + res_st[n].to(torch.float32)
                 for n in names}, clip=float(dp.clip))
            res_st = {n: torch.zeros_like(r) for n, r in res_st.items()}
            if sharded:
                delta_shards = se.shard_client_tree(deltas, mesh)
        if sharded:
            res_shards = se.shard_client_tree(res_st, mesh)
        groups = se.tree_group_count(tree_groups, C)
        k_masks = [sa.k_mask_for(size, C) if use_masks else 0
                   for size in sizes]
        signs_d = None
        masks = recovery = [None] * len(names)
        if use_masks:
            # every leaf's pair masks (and, in a dropout round, recovery
            # streams) in one launch each, from one copy of the matrices
            # per device; a sharded round makes each shard's rows of them
            # in one launch of its own
            leaves = [(1, km, size, leaf_id) for leaf_id, (km, size)
                      in enumerate(zip(k_masks, sizes))]
            with record_function("round.encode"):
                mats = {dev: se.round_matrices(dev, pair_seeds, pair_signs)}
                seeds_d, signs_d = mats[dev]
                if sharded:
                    for d in mesh.devices:
                        if d not in mats:
                            mats[d] = se.round_matrices(d, pair_seeds,
                                                        pair_signs)
                    rows = se.shard_map_clients(
                        lambda i0, d: se.mask_streams_rows_round(
                            *(x[i0:i0 + C // mesh.size] for x in mats[d]),
                            leaves, p=sa.p, q=sa.q), mesh, C)
                    masks = [[r[leaf_id] for r in rows]
                             for leaf_id in range(len(names))]
                else:
                    masks = se.mask_streams_round(seeds_d, signs_d, leaves,
                                                  p=sa.p, q=sa.q)
            if dropped:
                with record_function("round.decode"):
                    rec_d, alive_d = se.round_matrices(
                        dev, recovery_seeds,
                        [c not in dropped for c in participants])
                    recovery = se.recovery_streams_round(
                        rec_d, signs_d, alive_d, leaves, p=sa.p, q=sa.q)

        agg, new_res = {}, {}
        ks_acct, k_masks_acct = [], []
        for leaf_id, (name, k, size) in enumerate(zip(names, ks, sizes)):
            shape = state.params[name].shape
            r_st = res_st[name]
            k_mask = k_masks[leaf_id]
            enc_kw = dict(
                k=k, nb=1, m=size, size=size, selector=thgs.selector,
                sample_frac=thgs.sample_frac, pair_signs=signs_d,
                k_mask=k_mask, leaf_id=leaf_id, weights=w_vec, codec=codec,
                dp_sigma=dp_sigma_c, dp_seeds=dp_seeds,
                dp_support_seed=dp_sup_seed, masks=masks[leaf_id])
            if sharded:
                # ---- 2+3. client-parallel encode, the gather, the decode
                d_sh = [d[name] for d in delta_shards]
                dense, nr, streams_b = se.encode_decode_leaf_sharded(
                    mesh, d_sh, [r[name] for r in res_shards],
                    alive=alive if dropped else None,
                    recovery=recovery[leaf_id], topology=topology,
                    tree_groups=groups, device=dev, **enc_kw)
                if deltas is not None:
                    d_st = deltas[name]
                elif dropped or leaf_hook is not None:
                    with record_function("round.gather"):
                        d_st = se.all_gather_round(d_sh, dev)
            else:
                # ---- 2. batched unified-stream encode ----
                d_st = deltas[name]
                with record_function("round.encode"):
                    streams_b, nr = se.encode_leaf_batch(
                        d_st, r_st, pair_seeds=pair_seeds, mask_p=sa.p,
                        mask_q=sa.q, **enc_kw)
                # ---- 3. scatter-add decode (flat or tree) + recovery ----
                splits = (se.tree_splits(size, groups)
                          if topology == "tree" else None)
                with record_function("round.decode"):
                    dense = _decode(
                        streams_b, size, splits,
                        alive=alive if dropped else None,
                        pair_seeds=recovery_seeds if dropped else None,
                        pair_signs=signs_d if dropped else None,
                        k_mask=k_mask, mask_p=sa.p, mask_q=sa.q,
                        leaf_id=leaf_id, recovery=recovery[leaf_id])
            if leaf_hook is not None:
                leaf_hook(leaf_id, name, {
                    "updates": d_st, "residuals": r_st, "weights": w_vec,
                    "shards": mesh.size if sharded else 1, "alive": alive,
                    "streams": streams_b, "dense": dense,
                    "new_residuals": nr, "k": k, "k_mask": k_mask,
                    "size": size, "pair_seeds": pair_seeds,
                    "pair_signs": pair_signs,
                    "recovery_seeds": recovery_seeds if dropped else None,
                    "dropped": sorted(dropped), "codec": codec,
                    "dp_sigma": dp_sigma_c, "dp_seeds": dp_seeds,
                    "dp_support_seed": dp_sup_seed})
            agg[name] = _div(dense, w_surv_total).reshape(shape)
            # dropped clients transmitted nothing: their full accumulator
            # carries over as error feedback
            if dropped:
                keep = alive.reshape((C,) + (1,) * len(shape))
                nr = torch.where(keep, nr, (r_st + d_st).to(nr.dtype))
            new_res[name] = nr
            ks_acct.append(min(int(k), size))
            k_masks_acct.append(k_mask)

        for ci, c in enumerate(participants):
            state.residuals[c] = {n: new_res[n][ci] for n in names}
        rec = costs.round_record(
            state.round, model_size, ks_acct, k_masks_acct,
            n_clients=C, bits=bits, n_survivors=len(survivors),
            threshold=proto.t if use_masks else 0, codec=codec,
            leaf_sizes=sizes,
            # inactive DP parts stay at the 0.0 defaults, so sigma=0 /
            # clip=inf records equal records without DP
            dp_clip=float(dp.clip) if dp_active and dp.clips else 0.0,
            dp_sigma=float(dp.sigma) if dp_active else 0.0,
            dp_delta=float(dp.delta) if dp_active and dp.noised else 0.0)
    else:
        if codec != "f32":
            raise ValueError(
                f"codec {codec!r} requires THGS sparse streams; dense rounds "
                "have no stream wire to quantize (thgs is None)")
        surv_idx = [participants.index(c) for c in survivors]
        if sa.enabled:
            from repro_torch.core.secure_agg import dense_masked_update

            # dense Bonawitz has no sparse-support reconstruction: masks
            # are agreed among the survivors (the baseline's re-run
            # assumption); leaf i's masks are keyed with leaf id i
            agg = {n: _div(sum(dense_masked_update(
                deltas[n][participants.index(c)], sa, c, survivors,
                state.round, i) for c in survivors), len(survivors)).to(
                    state.params[n].dtype)
                for i, n in enumerate(names)}
        else:
            agg = {n: _div(sum(deltas[n][i] for i in surv_idx),
                           len(surv_idx))
                   for n in names}
        rec = costs.dense_round_record(
            state.round, model_size, n_clients=C, bits=bits,
            n_survivors=len(survivors))

    for ci, c in enumerate(participants):
        state.losses[c] = losses_list[ci]
    state.params = {n: state.params[n] + fed.server_lr * agg[n]
                    for n in names}
    state.comm_log.append(rec)
    state.round += 1
    return state


# ------------------------------------------ async (FedBuff-style) updates
def staleness_weight(tau: int) -> float:
    """FedBuff's polynomial staleness discount ``(1 + tau)^(-1/2)``: a
    report trained on params ``tau`` server updates old; ``tau == 0`` gives
    weight 1, so an all-fresh buffer is the synchronous round."""
    return (1.0 + float(tau)) ** -0.5


def run_async_update(
    state: FederatedState,
    client_batches: dict[int, Any],
    client_params: Mapping[int, Params],
    loss_fn: LossFn,
    fed: FedConfig,
    thgs: THGSConfig,
    bits: costs.BitModel = costs.PAPER_BITS,
    staleness: Mapping[int, int] | None = None,
    client_weights: Mapping[int, float] | None = None,
    codec: str = "f32",
    topology: str = "flat",
    tree_groups: int = 0,
) -> FederatedState:
    """One FedBuff-style buffered server update.

    The buffer holds one report per client of ``client_batches``: client
    ``c`` ran local SGD from ``client_params[c]``, ``staleness[c]`` server
    updates old, and its THGS stream joins the aggregate with weight
    ``staleness_weight(tau) * client_weights[c]``; the server divides by
    the total weight. With every tau 0 this is ``run_round`` without secure
    aggregation, bit for bit. No secure aggregation (pair masks need a
    round-synchronous cohort) and THGS is required; the buffer's clients
    are distinct (the residual write-back is per client)."""
    if thgs is None:
        raise ValueError("run_async_update requires THGS sparse streams")
    _check_topology(topology, thgs)
    participants = sorted(client_batches.keys())
    B = len(participants)
    staleness = staleness or {}
    taus = [int(staleness.get(c, 0)) for c in participants]
    w_list = [staleness_weight(t) *
              (float(client_weights.get(c, 1.0)) if client_weights else 1.0)
              for c, t in zip(participants, taus)]
    names = list(state.params)
    dev = state.params[names[0]].device
    w_vec = torch.tensor(w_list, dtype=torch.float32, device=dev)
    w_total = float(sum(w_list))
    sizes = [state.params[n].numel() for n in names]
    model_size = sum(sizes)

    # ---- 1. every report's local SGD from its own stale params ----
    batches_stacked = tuple(
        torch.stack([client_batches[c][i] for c in participants])
        for i in range(len(client_batches[participants[0]])))
    params_stacked = {n: torch.stack([client_params[c][n]
                                      for c in participants]) for n in names}
    prox_mu = fed.prox_mu if fed.algorithm == "fedprox" else 0.0
    with record_function("round.local_sgd"):
        deltas, losses = batched_client_update_multi(
            params_stacked, batches_stacked, loss_fn, fed.local_steps,
            fed.local_lr, prox_mu)
        losses_list = [float(x) for x in losses.tolist()]

    loss_prev = _mean_or_none([state.losses.get(c) for c in participants])
    loss_curr = _mean_or_none(losses_list)
    ks = schedules.leaf_ks(thgs, sizes, t=state.round,
                           total_rounds=fed.rounds, loss_prev=loss_prev,
                           loss_curr=loss_curr)
    groups = se.tree_group_count(tree_groups, B)

    agg, new_res = {}, {}
    for leaf_id, (name, k, size) in enumerate(zip(names, ks, sizes)):
        d_st = deltas[name]
        r_st = torch.stack([state.residuals[c][name] for c in participants])
        # ---- 2. batched unified-stream encode, staleness-weighted ----
        with record_function("round.encode"):
            streams_b, nr = se.encode_leaf_batch(
                d_st, r_st, k=k, nb=1, m=size, size=size,
                selector=thgs.selector, sample_frac=thgs.sample_frac,
                leaf_id=leaf_id, weights=w_vec, codec=codec)
        # ---- 3. decode, flat or tree ----
        splits = se.tree_splits(size, groups) if topology == "tree" else None
        with record_function("round.decode"):
            dense = _decode(streams_b, size, splits)
        agg[name] = _div(dense, w_total).reshape(state.params[name].shape)
        new_res[name] = nr

    for ci, c in enumerate(participants):
        state.residuals[c] = {n: new_res[n][ci] for n in names}
        state.losses[c] = losses_list[ci]
    rec = costs.round_record(
        state.round, model_size, [min(int(k), s) for k, s in zip(ks, sizes)],
        [0] * len(ks), n_clients=B, bits=bits, n_survivors=B, threshold=0,
        codec=codec, leaf_sizes=sizes, staleness=tuple(taus))
    state.params = {n: state.params[n] + fed.server_lr * agg[n]
                    for n in names}
    state.comm_log.append(rec)
    state.round += 1
    return state
