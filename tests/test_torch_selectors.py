"""Port parity: the 'sampled' and 'local' THGS selectors through every
encode, against the JAX reference on shared numpy inputs.

* ``select_topk_rows`` over a batch of rows against the reference's per-row
  ``vmap`` (NaN, tied and all-zero rows included);
* ``encode_leaf_batch`` / ``decode_leaf_batch`` under 'sampled'
  (``tests/test_streams.py``'s batched case, with masks, weights and blocks
  too), ``secure_agg.encode_leaf``, and the client-sharded leaf against the
  reference's serial encode + decode — all bit-equal;
* sharded == serial and 'local' == 'exact' inside the port, whole runs;
* two-round cuts of ``table2_quick`` (each selector) and ``async_quick``
  ('sampled') with the reference's initial parameters injected: the ledger's
  slot facts exactly, losses and parameters within rtol 1e-4, atol 1e-5
  (local SGD sums in another order, as ``test_torch_tree_async.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import masks as jmasks  # noqa: E402
from repro.core import secure_agg as jsa  # noqa: E402
from repro.core import streams as jse  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.secagg.protocol import RoundProtocol as JProto  # noqa: E402
from repro.sim import presets as jpresets  # noqa: E402
from repro.sim.engine import AsyncSimulation as JAsync  # noqa: E402
from repro.sim.engine import Simulation as JSim  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import secure_agg as tsa  # noqa: E402
from repro_torch.core import streams as tse  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.launch.mesh import ClientsMesh  # noqa: E402
from repro_torch.secagg.protocol import RoundProtocol as TProto  # noqa: E402
from repro_torch.sim import presets as tpresets  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.engine import AsyncSimulation, Simulation  # noqa: E402

CPU = torch.device("cpu")


def _bits(a):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(torch_t, jax_a):
    np.testing.assert_array_equal(_bits(torch_t), _bits(jax_a))


def _rows(seed: int, rows: int, m: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    acc = rs.standard_normal((rows, m)).astype(np.float32)
    if rows >= 4:
        acc[1] = np.round(acc[1] * 2) / 2            # ties of both signs
        acc[2, rs.choice(m, m // 2, replace=False)] = np.nan  # NaN threshold
        acc[3] = 0.0                                  # all zero
    return acc


# ------------------------------------------------------------ the selector
@pytest.mark.parametrize("rows,m,k,f", [(6, 5000, 50, 0.05), (4, 1500, 700,
                                                              0.01),
                                        (4, 300, 20, 0.01), (2, 3001, 1, 0.2)])
def test_select_topk_rows_sampled_matches_reference_vmap(rows, m, k, f):
    acc = _rows(rows + m, rows, m)
    want = np.asarray(jse.select_topk_rows(jnp.asarray(acc), k, "sampled", f))
    got = tse.select_topk_rows(torch.from_numpy(acc), k, "sampled", f)
    np.testing.assert_array_equal(got.numpy(), want)
    # a [C, nb, m] batch in one call: each client's rows as the reference's
    batch = np.stack([acc, acc[::-1].copy()])
    got3 = tse.select_topk_rows(torch.from_numpy(batch), k, "sampled", f)
    for c in range(2):
        np.testing.assert_array_equal(got3[c].numpy(), np.asarray(
            jse.select_topk_rows(jnp.asarray(batch[c]), k, "sampled", f)))


@pytest.mark.parametrize("selector", ["exact", "local"])
def test_select_topk_rows_exact_and_local_match_reference(selector):
    acc = _rows(1, 4, 2000)
    want = np.asarray(jse.select_topk_rows(jnp.asarray(acc), 30, selector,
                                           0.01))
    got = tse.select_topk_rows(torch.from_numpy(acc), 30, selector)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- the batched encode
def _protocols(parts, round_t, mask_ratio):
    js = jtypes.SecureAggConfig(mask_ratio=mask_ratio, seed=0x5EC0DE)
    ts = ttypes.SecureAggConfig(mask_ratio=mask_ratio, seed=0x5EC0DE)
    return js, JProto.setup(js, parts, round_t), TProto.setup(ts, parts,
                                                             round_t)


# (C, nb, m, k, f, mask_ratio, weighted, dropped)
BATCH_CASES = {
    "reference-case": (3, 1, 5000, 50, 0.05, 0.0, False, ()),
    "masks-weights": (5, 1, 3000, 40, 0.01, 0.05, True, ()),
    "masks-dropout": (5, 1, 2000, 25, 0.02, 0.05, True, (1, 3)),
    "blocks": (4, 3, 1500, 30, 0.01, 0.0, True, ()),
    "small-leaf": (3, 1, 200, 12, 0.01, 0.1, False, ()),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_encode_decode_leaf_batch_sampled_bit_equal(case):
    C, nb, m, k, f, mask_ratio, weighted, dropped = BATCH_CASES[case]
    size = nb * m - (5 if nb > 1 else 0)
    rs = np.random.RandomState(len(case) + C * m)
    upd = rs.standard_normal((C, size)).astype(np.float32)
    res = (0.3 * rs.standard_normal((C, size))).astype(np.float32)
    w = (rs.uniform(0.5, 2.0, C).astype(np.float32) if weighted
         else np.ones(C, np.float32))
    jkw, tkw, jdkw, tdkw = {}, {}, {}, {}
    parts = list(range(1, C + 1))
    if mask_ratio:
        jsa_, jp, tp = _protocols(parts, 1, mask_ratio)
        km = jsa_.k_mask_for(m, C)
        js, jsg = jp.pair_seed_matrix()
        ts, tsg = tp.pair_seed_matrix()
        jkw.update(pair_seeds=js, pair_signs=jsg, k_mask=km)
        tkw.update(pair_seeds=ts, pair_signs=tsg, k_mask=km)
        if dropped:
            alive = np.array([c not in dropped for c in range(C)])
            surv = [p for p, a in zip(parts, alive) if a]
            drop = [p for p, a in zip(parts, alive) if not a]
            jdkw.update(alive=jnp.asarray(alive), k_mask=km,
                        pair_seeds=jp.recover_seeds(surv, drop),
                        pair_signs=jsg)
            tdkw.update(alive=torch.from_numpy(alive), k_mask=km,
                        pair_seeds=tp.recover_seeds(surv, drop),
                        pair_signs=tsg)
    jst, jres = jse.encode_leaf_batch(
        jnp.asarray(upd), jnp.asarray(res), k=k, nb=nb, m=m, size=size,
        selector="sampled", sample_frac=f, leaf_id=2,
        weights=jnp.asarray(w), **jkw)
    tst, tres = tse.encode_leaf_batch(
        torch.from_numpy(upd), torch.from_numpy(res), k=k, nb=nb, m=m,
        size=size, selector="sampled", sample_frac=f, leaf_id=2,
        weights=torch.from_numpy(w), **tkw)
    _assert_bits(tst.indices, jst.indices)
    _assert_bits(tst.values, jst.values)
    _assert_bits(tres, jres)
    jd = jse.decode_leaf_batch(jst, nb=nb, m=m, size=size, leaf_id=2,
                               **jdkw)
    td = tse.decode_leaf_batch(tst, nb=nb, m=m, size=size, leaf_id=2,
                               **tdkw)
    _assert_bits(td, jd)
    if not mask_ratio:      # tests/test_streams.py's conservation check
        np.testing.assert_allclose(
            td.numpy(), (w[:, None] * (upd + res - tres.numpy())).sum(0),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("selector", ["sampled", "local"])
@pytest.mark.parametrize("size,with_mask", [(300, False), (3000, True),
                                            (4100, False)])
def test_secure_agg_encode_leaf_bit_equal(size, with_mask, selector):
    rs = np.random.RandomState(size)
    g = rs.standard_normal(size).astype(np.float32)
    r = (0.1 * rs.standard_normal(size)).astype(np.float32)
    jmask = tmask = None
    if with_mask:
        ja = jtypes.SecureAggConfig(mask_ratio=0.05, seed=9)
        ta = ttypes.SecureAggConfig(mask_ratio=0.05, seed=9)
        jmask = jmasks.client_masks(ja, 1, [0, 1, 2, 3], 0, 0, size, 40)
        tmask = tmasks.client_masks(ta, 1, [0, 1, 2, 3], 0, 0, size, 40,
                                    device="cpu")
    jcfg = jtypes.THGSConfig(selector=selector, sample_frac=0.02)
    tcfg = ttypes.THGSConfig(selector=selector, sample_frac=0.02)
    want = jsa.encode_leaf(jnp.asarray(g), jnp.asarray(r), 60, jcfg, jmask)
    got = tsa.encode_leaf(torch.from_numpy(g), torch.from_numpy(r), 60,
                          tcfg, tmask)
    _assert_bits(got.stream.indices, want.stream.indices)
    _assert_bits(got.stream.values, want.stream.values)
    _assert_bits(got.residual, want.residual)


@pytest.mark.parametrize("shards,mask_ratio,codec", [(3, 0.05, "f32"),
                                                     (2, 0.0, "int8")])
def test_sharded_leaf_sampled_bit_equal_to_reference_serial(shards,
                                                            mask_ratio,
                                                            codec):
    C, m, k, f = 6, 2500, 30, 0.02
    rs = np.random.RandomState(shards)
    upd = (0.01 * rs.standard_normal((C, m))).astype(np.float32)
    res = (0.005 * rs.standard_normal((C, m))).astype(np.float32)
    w = rs.uniform(0.5, 3.0, C).astype(np.float32)
    jkw, tkw = {}, {}
    if mask_ratio:
        jsa_, jp, tp = _protocols(list(range(1, C + 1)), 2, mask_ratio)
        km = jsa_.k_mask_for(m, C)
        js, jsg = jp.pair_seed_matrix()
        ts, tsg = tp.pair_seed_matrix()
        jkw.update(pair_seeds=js, pair_signs=jsg, k_mask=km)
        tkw.update(pair_seeds=ts, pair_signs=tsg, k_mask=km)
    jst, jres = jse.encode_leaf_batch(
        jnp.asarray(upd), jnp.asarray(res), k=k, nb=1, m=m, size=m,
        selector="sampled", sample_frac=f, leaf_id=1,
        weights=jnp.asarray(w), codec=codec, **jkw)
    jd = jse.decode_leaf_batch(jst, nb=1, m=m, size=m, leaf_id=1)
    td, tres, tst = tse.encode_decode_leaf_sharded(
        ClientsMesh((CPU,) * shards), torch.from_numpy(upd),
        torch.from_numpy(res), k=k, nb=1, m=m, size=m, selector="sampled",
        sample_frac=f, leaf_id=1, weights=torch.from_numpy(w), codec=codec,
        **tkw)
    _assert_bits(td, jd)
    _assert_bits(tres, jres)
    _assert_bits(tst.indices, jst.indices)
    _assert_bits(tst.values, jst.values)


# ---------------------------------------------------- whole runs in the port
_PARITY = SimConfig(
    name="parity", model="mnist_mlp", dataset="mnist", rounds=2,
    n_clients=12, clients_per_round=6, n_train=600, n_test=200,
    local_steps=2, local_batch=16, eval_every=1,
    thgs=ttypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01,
                           selector="sampled", sample_frac=0.02),
    sa=ttypes.SecureAggConfig(mask_ratio=0.02, seed=3), dropout_rate=0.4,
    weight_by_data_count=True, seed=1, shard_clients="off", out_json=None)


def _teq(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _assert_states_equal(a, ra, b, rb):
    for n in b.state.params:
        assert _teq(a.state.params[n], b.state.params[n]), n
    for c in b.state.residuals:
        for n in b.state.params:
            assert _teq(a.state.residuals[c][n], b.state.residuals[c][n])
    assert ra.ledger.entries == rb.ledger.entries
    assert ra.accuracies == rb.accuracies


def test_sharded_run_equals_serial_under_sampled():
    serial = Simulation(_PARITY, device="cpu")
    rs = serial.run(resume=False)
    sharded = Simulation(_PARITY, device="cpu")
    sharded.mesh = ClientsMesh((CPU,) * 3)
    seen = []
    sharded.leaf_hook = lambda i, n, info: seen.append(info["shards"])
    rsh = sharded.run(resume=False)
    assert set(seen) == {3}
    _assert_states_equal(sharded, rsh, serial, rs)
    assert any(e.n_survivors < e.n_clients for e in rs.ledger.entries)


@pytest.mark.parametrize("preset", ["ci_smoke", "async_quick"])
def test_local_equals_exact(preset):
    """'local' is 'exact' on every round path (the caller pre-blocks)."""
    base = tpresets.get(preset).replace(rounds=2, out_json=None)
    runs = []
    for selector in ("exact", "local"):
        cfg = base.replace(thgs=ttypes.THGSConfig(
            **{**base.thgs.__dict__, "selector": selector}))
        sim = (AsyncSimulation if cfg.mode == "async" else Simulation)(
            cfg, device="cpu")
        runs.append((sim, sim.run(resume=False)))
    _assert_states_equal(*runs[0], *runs[1])


# ------------------------------------------------- against the reference
def _facts(ledger):
    return [(e.ks, e.k_masks, e.n_clients, e.n_survivors, e.threshold,
             e.staleness) for e in ledger.entries]


@pytest.mark.parametrize("preset,selector", [("table2_quick", "sampled"),
                                             ("table2_quick", "local"),
                                             ("async_quick", "sampled")])
def test_two_round_cut_matches_reference(preset, selector):
    over = dict(rounds=2, eval_every=1, out_json=None)
    jcfg = jpresets.get(preset).replace(**over)
    jcfg = jcfg.replace(thgs=jtypes.THGSConfig(
        **{**jcfg.thgs.__dict__, "selector": selector}))
    tcfg = tpresets.get(preset).replace(**over)
    tcfg = tcfg.replace(thgs=ttypes.THGSConfig(
        **{**tcfg.thgs.__dict__, "selector": selector}))
    jsim = (JAsync if jcfg.mode == "async" else JSim)(jcfg)
    jres = jsim.run(resume=False)
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
    for path, v in jax.tree_util.tree_flatten_with_path(
            jsim.state.params)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(tsim.state.params[name].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-5)
