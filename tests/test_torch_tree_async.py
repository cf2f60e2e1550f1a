"""Port of slice D: the hierarchical (tree) decode and the FedBuff-style
async update, inside the port and against the JAX reference.

* Tree: ``tree_splits`` equals the reference's; the tree decode is bit-equal
  to the flat decode for random partitions (uneven, width-1 ranges, a -0.0
  sum), with and without dropout recovery; ``run_round(topology='tree')``
  equals ``'flat'``.
* Async: ``staleness_weight``; an all-fresh buffer is the synchronous round
  bit for bit; staleness is exactly a multiplicative weight; async tree ==
  async flat; the rejections; ``simulate`` routes by mode.
* Parity: two-round cuts of ``tree_quick`` and ``async_quick`` with the
  reference's initial parameters injected give the reference's ledger slot
  facts (ks, k_masks, survivors, staleness) exactly, and losses and
  parameters within rtol 1e-4, atol 1e-5 (local SGD in f32 sums in another
  order; measured differences are about 1e-6).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import streams as jse  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.sim import presets as jpresets  # noqa: E402
from repro.sim.engine import simulate as jsimulate  # noqa: E402
from repro_torch.core import fedavg as tfa  # noqa: E402
from repro_torch.core import streams as se  # noqa: E402
from repro_torch.core.types import (FedConfig, SecureAggConfig,  # noqa: E402
                                    THGSConfig)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402
from repro_torch.secagg.protocol import RoundProtocol  # noqa: E402
from repro_torch.sim import presets as tpresets  # noqa: E402
from repro_torch.sim.engine import (AsyncSimulation, Simulation,  # noqa: E402
                                    simulate)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "1"}
THGS = THGSConfig(s0=0.2, alpha=0.9, s_min=0.05, time_varying=False)


def _bits(x):
    return x.numpy().view(np.int32)


def _random_splits(rs, padded):
    n_cuts = int(rs.randint(0, min(5, padded - 1) + 1))
    cuts = rs.choice(np.arange(1, padded), size=n_cuts, replace=False)
    return (0, *sorted(int(c) for c in cuts), padded)


# --------------------------------------------------------------- tree decode
@pytest.mark.parametrize("padded,groups", [(1, 1), (1, 5), (10, 3),
                                           (156800, 3), (2359296, 7),
                                           (7, 7), (7, 100)])
def test_tree_splits_match_reference(padded, groups):
    assert se.tree_splits(padded, groups) == jse.tree_splits(padded, groups)


@pytest.mark.parametrize("case", range(8))
def test_tree_decode_bit_equal_to_flat_for_random_partitions(case):
    """Any partition, weights, duplicates, +-0.0: every position folds the
    same contributions in the same slot order as the flat decode."""
    rs = np.random.RandomState(100 + case)
    C, nb, m = int(rs.randint(1, 6)), int(rs.randint(1, 4)), \
        int(rs.randint(2, 60))
    k = int(rs.randint(1, 3 * m))
    idx = rs.randint(0, nb * m, (C, nb, k)).astype(np.int32)
    vals = rs.randn(C, nb, k).astype(np.float32)
    vals[rs.rand(C, nb, k) < 0.1] = -0.0
    # a position that only ever receives -0.0 (its fold from +0.0 is +0.0)
    idx[..., 0] = nb * m - 1
    vals[idx == nb * m - 1] = -0.0
    w = rs.uniform(0.1, 3.0, C).astype(np.float32)
    st = se.StreamBatch(torch.from_numpy(idx), torch.from_numpy(vals))
    flat = se.decode_sum_blocks(st, nb, m, weights=torch.from_numpy(w))
    for _ in range(4):
        splits = _random_splits(rs, nb * m)
        tree = se.decode_sum_tree(st, nb, m, splits=splits,
                                  weights=torch.from_numpy(w))
        np.testing.assert_array_equal(_bits(tree), _bits(flat),
                                      err_msg=str(splits))
    jst = jse.StreamBatch(indices=jax.numpy.asarray(idx),
                          values=jax.numpy.asarray(vals))
    jflat = jse.decode_sum_blocks(jst, nb, m,
                                  weights=jax.numpy.asarray(w))
    np.testing.assert_array_equal(_bits(flat), np.asarray(jflat).view(
        np.int32))


def test_tree_decode_one_launch_per_nonempty_group_and_validates_splits(
        monkeypatch):
    st = se.StreamBatch(torch.tensor([[[0, 3, 5]]], dtype=torch.int32),
                        torch.tensor([[[1.0, 2.0, 3.0]]]))
    with pytest.raises(ValueError, match="monotone"):
        se.decode_sum_tree(st, 1, 6, splits=(0, 4, 3, 6))
    with pytest.raises(ValueError, match="monotone"):
        se.decode_sum_tree(st, 1, 6, splits=(0, 5))
    calls = []
    real = ops.stream_scatter_add

    def spy(i, v, *, size):
        calls.append(size)
        return real(i, v, size=size)

    monkeypatch.setattr(se.ops, "stream_scatter_add", spy)
    out = se.decode_sum_tree(st, 1, 6, splits=(0, 2, 2, 6))
    assert calls == [3, 5]          # each group's width + its dump slot
    assert out.tolist() == [1.0, 0.0, 0.0, 2.0, 0.0, 3.0]


@pytest.mark.parametrize("case", range(4))
def test_tree_decode_bit_equal_to_flat_with_dropout_recovery(case):
    """A masked round with survivors >= the Shamir threshold: the recovery
    streams join before the range routing and cancel inside each group."""
    rs = np.random.RandomState(200 + case)
    C, size = int(rs.randint(3, 7)), int(rs.randint(50, 400))
    sa = SecureAggConfig(mask_ratio=0.05, threshold=0.6, seed=case)
    parts = list(range(C))
    proto = RoundProtocol.setup(sa, parts, 0)
    seeds, signs = proto.pair_seed_matrix()
    t = proto.t
    n_drop = int(rs.randint(1, C - t + 1)) if C > t else 0
    dropped = sorted(rs.choice(C, n_drop, replace=False).tolist())
    survivors = [c for c in parts if c not in dropped]
    rec = proto.recover_seeds(survivors, dropped) if dropped else None
    alive = torch.tensor([c not in dropped for c in parts])
    k_mask = sa.k_mask_for(size, C)
    upd = torch.from_numpy(rs.randn(C, size).astype(np.float32))
    res = torch.from_numpy(0.1 * rs.randn(C, size).astype(np.float32))
    w = torch.from_numpy(rs.uniform(0.5, 2.0, C).astype(np.float32))
    st, _ = se.encode_leaf_batch(upd, res, k=size // 5, nb=1, m=size,
                                 size=size, pair_seeds=seeds,
                                 pair_signs=signs, k_mask=k_mask, leaf_id=2,
                                 weights=w)
    kw = dict(nb=1, m=size, size=size, k_mask=k_mask, leaf_id=2,
              alive=alive if dropped else None,
              pair_seeds=rec, pair_signs=signs if dropped else None)
    flat = se.decode_leaf_batch(st, **kw)
    for _ in range(3):
        tree = se.decode_leaf_tree(st, splits=_random_splits(rs, size), **kw)
        np.testing.assert_array_equal(_bits(tree), _bits(flat))


# ---------------------------------------------------------- rounds, in port
def _setup(C=4, steps=2, batch=8, seed=0):
    model = tpm.build_model("mnist_mlp")
    model.init_(torch.Generator().manual_seed(seed))
    params = {n: p.detach().clone() for n, p in model.params().items()}
    rs = np.random.RandomState(seed + 1)
    batches = {c: (torch.from_numpy(rs.randn(steps, batch, 28, 28, 1)
                                    .astype(np.float32)),
                   torch.from_numpy(rs.randint(0, 10, (steps, batch))))
               for c in range(C)}
    fed = FedConfig(n_clients=C, clients_per_round=C, local_steps=steps,
                    local_batch=batch, local_lr=0.05, rounds=10)
    return tpm.cross_entropy_loss(model), params, batches, fed


def _state_equal(a, b):
    for n in a.params:
        np.testing.assert_array_equal(_bits(a.params[n]), _bits(b.params[n]))
    for c in a.residuals:
        for n in a.residuals[c]:
            np.testing.assert_array_equal(_bits(a.residuals[c][n]),
                                          _bits(b.residuals[c][n]))


@pytest.mark.parametrize("dropped,groups", [((), 0), ((), 3), ((1,), 2),
                                            ((0, 3), 5)])
def test_run_round_tree_equals_flat(dropped, groups):
    loss_fn, params, batches, fed = _setup(C=5)
    sa = SecureAggConfig(mask_ratio=0.02, threshold=0.6)
    out = {}
    for topo in ("flat", "tree"):
        out[topo] = tfa.run_round(
            tfa.init_state(params, fed), batches, loss_fn, fed, THGS, sa,
            dropped=dropped, topology=topo, tree_groups=groups)
    _state_equal(out["flat"], out["tree"])
    assert out["flat"].comm_log == out["tree"].comm_log
    with pytest.raises(ValueError, match="requires THGS"):
        tfa.run_round(tfa.init_state(params, fed), batches, loss_fn, fed,
                      None, SecureAggConfig(enabled=False), topology="tree")
    with pytest.raises(ValueError, match="unknown topology"):
        tfa.run_round(tfa.init_state(params, fed), batches, loss_fn, fed,
                      THGS, sa, topology="star")


def test_staleness_weight_values():
    assert tfa.staleness_weight(0) == 1.0
    assert tfa.staleness_weight(3) == pytest.approx(0.5)
    ws = [tfa.staleness_weight(t) for t in range(6)]
    assert ws == sorted(ws, reverse=True) and all(w > 0 for w in ws)
    from repro.core.fedavg import staleness_weight as jsw
    assert ws == [jsw(t) for t in range(6)]


def test_all_fresh_buffer_is_the_sync_round():
    loss_fn, params, batches, fed = _setup()
    weights = {c: float(c + 1) for c in batches}
    s_sync = tfa.run_round(tfa.init_state(params, fed), batches, loss_fn,
                           fed, THGS, SecureAggConfig(enabled=False),
                           client_weights=weights)
    s_async = tfa.run_async_update(
        tfa.init_state(params, fed), batches, {c: params for c in batches},
        loss_fn, fed, THGS, client_weights=weights)
    _state_equal(s_sync, s_async)
    assert s_sync.losses == s_async.losses
    r_s, r_a = s_sync.comm_log[-1], s_async.comm_log[-1]
    assert (r_s.ks, r_s.model_size, r_s.n_clients, r_s.upload_bits) == (
        r_a.ks, r_a.model_size, r_a.n_clients, r_a.upload_bits)
    assert r_a.staleness == (0,) * len(batches) and r_s.staleness == ()


def test_staleness_is_exactly_a_multiplicative_weight():
    loss_fn, params, batches, fed = _setup()
    older = {n: p * 0.9 for n, p in params.items()}
    client_params = {0: params, 1: older, 2: older, 3: params}
    taus = {0: 0, 1: 2, 2: 1, 3: 0}
    base = {c: float(c + 1) for c in batches}
    s_tau = tfa.run_async_update(
        tfa.init_state(params, fed), batches, client_params, loss_fn, fed,
        THGS, staleness=taus, client_weights=base)
    folded = {c: base[c] * tfa.staleness_weight(taus[c]) for c in batches}
    s_fold = tfa.run_async_update(
        tfa.init_state(params, fed), batches, client_params, loss_fn, fed,
        THGS, client_weights=folded)
    _state_equal(s_tau, s_fold)
    assert s_tau.comm_log[-1].staleness == (0, 2, 1, 0)


def test_async_tree_equals_async_flat_and_rejections():
    loss_fn, params, batches, fed = _setup()
    older = {n: p * 0.95 for n, p in params.items()}
    client_params = {c: (older if c % 2 else params) for c in batches}
    taus = {c: c % 3 for c in batches}
    flat = tfa.run_async_update(tfa.init_state(params, fed), batches,
                                client_params, loss_fn, fed, THGS,
                                staleness=taus)
    tree = tfa.run_async_update(tfa.init_state(params, fed), batches,
                                client_params, loss_fn, fed, THGS,
                                staleness=taus, topology="tree",
                                tree_groups=3)
    _state_equal(flat, tree)
    assert flat.comm_log == tree.comm_log
    with pytest.raises(ValueError, match="requires THGS"):
        tfa.run_async_update(tfa.init_state(params, fed), batches,
                             client_params, loss_fn, fed, None)
    with pytest.raises(ValueError, match="unknown topology"):
        tfa.run_async_update(tfa.init_state(params, fed), batches,
                             client_params, loss_fn, fed, THGS,
                             topology="star")


@pytest.mark.parametrize("over,match", [
    ({"sa": SecureAggConfig()}, "secure aggregation"),
    ({"dropout_rate": 0.1}, "no dropout"),
    ({"buffer_size": 13}, "buffer_size"),
    ({"max_staleness": -1}, "max_staleness"),
    ({"thgs": None}, "requires THGS"),
    ({"shard_clients": "on"}, "serial update path"),
])
def test_async_config_rejections(over, match):
    cfg = tpresets.get("async_quick").replace(**over)
    with pytest.raises(ValueError, match=match):
        cfg.validate()


def test_config_rejections_outside_async():
    from repro_torch.core.dp import DPConfig

    base = tpresets.get("async_quick")
    with pytest.raises(ValueError, match="dp cannot run with mode='async'"):
        base.replace(dp=DPConfig(clip=1.0, sigma=0.5)).validate()
    with pytest.raises(ValueError, match="buffer_size is only meaningful"):
        base.replace(mode="sync").validate()
    with pytest.raises(ValueError, match="tree_groups"):
        tpresets.get("tree_quick").replace(tree_groups=-1).validate()
    with pytest.raises(ValueError, match="requires THGS"):
        tpresets.get("tree_quick").replace(
            thgs=None, sa=SecureAggConfig(enabled=False)).validate()
    base.replace(ckpt_dir="ck", ckpt_every=1).validate()   # slice F runs it


def test_simulate_routes_by_mode():
    sync = tpresets.get("ci_smoke").replace(rounds=1, out_json=None)
    asyn = tpresets.get("async_quick").replace(rounds=1, n_train=300,
                                               n_test=100, out_json=None)
    with pytest.raises(ValueError, match="simulate"):
        Simulation(asyn, device="cpu")
    res = simulate(asyn, device="cpu")
    assert res.ledger.entries[0].staleness == (0, 0, 0, 0)
    assert simulate(sync, device="cpu").ledger.entries[0].staleness == ()
    assert isinstance(AsyncSimulation(asyn, device="cpu").buffer, int)


# ------------------------------------------------- parity with the reference
def _facts(ledger):
    return [(e.ks, e.k_masks, e.n_clients, e.n_survivors, e.threshold,
             e.staleness) for e in ledger.entries]


@pytest.mark.parametrize("preset", ["tree_quick", "async_quick"])
def test_two_round_cut_matches_reference(preset):
    over = dict(rounds=2, eval_every=1, out_json=None)
    jcfg = jpresets.get(preset).replace(**over)
    tcfg = tpresets.get(preset).replace(**over)
    jres = jsimulate(jcfg, resume=False)
    init = jax.tree_util.tree_map(
        np.asarray, jpm.PAPER_MODELS[jcfg.model].init(
            jax.random.key(jcfg.seed)))
    tsim = (AsyncSimulation if tcfg.mode == "async" else Simulation)(
        tcfg, device="cpu", init_params=init)
    tres = tsim.run()
    assert _facts(tres.ledger) == _facts(jres.ledger)
    for acct in ("paper", "tpu"):
        assert tres.ledger.totals(acct) == jres.ledger.totals(acct)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tres.accuracies, jres.accuracies, atol=0.02)
    assert tres.summary()["config"] == jcfg.to_dict() | {"dp": None}
    if preset == "tree_quick":
        assert [e.n_survivors for e in tres.ledger.entries] == [5, 6]
    else:
        assert [e.staleness for e in tres.ledger.entries] == [
            (0, 0, 0, 0), (0, 1, 0, 0)]


def test_two_round_parameters_match_reference():
    """The parameters after two ``tree_quick`` rounds: within rtol 1e-4,
    atol 1e-5 of the reference's (the same tolerance as the losses)."""
    from repro.sim.engine import Simulation as JSim

    over = dict(rounds=2, eval_every=1, out_json=None)
    jsim = JSim(jpresets.get("tree_quick").replace(**over))
    jsim.run(resume=False)
    init = jax.tree_util.tree_map(
        np.asarray, jpm.PAPER_MODELS["mnist_mlp"].init(jax.random.key(11)))
    tsim = Simulation(tpresets.get("tree_quick").replace(**over),
                      device="cpu", init_params=init)
    tsim.run()
    for path, v in jax.tree_util.tree_flatten_with_path(
            jsim.state.params)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(tsim.state.params[name].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-5)


def _cli(tmp_path, *args):
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim", "--device", "cpu", *args],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def test_cli_tree_and_async_headers_and_staleness_json(tmp_path):
    import json

    out = _cli(tmp_path, "--preset", "tree_quick", "--rounds", "1",
               "--tree-groups", "2", "--out", str(tmp_path / "t.json"))
    assert re.search(r"topology=tree groups=2 device=cpu", out)
    assert "secagg control" in out
    out = _cli(tmp_path, "--preset", "async_quick", "--rounds", "2",
               "--out", str(tmp_path / "a.json"))
    assert "mode=async buffer=4 max_staleness=3" in out
    doc = json.loads((tmp_path / "a.json").read_text())
    assert [e["staleness"] for e in doc["ledger"]["entries"]] == [
        [0, 0, 0, 0], [0, 1, 0, 0]]
