"""Port parity: the stream engine (``repro_torch.core.streams``) against
``repro.core.streams`` on shared numpy inputs — selection, the
first-occurrence gate, the pair-mask layout, the leaf encode and the decode
(with and without dropout recovery) are bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import streams as jse  # noqa: E402
from repro.core.types import SecureAggConfig as JSA  # noqa: E402
from repro.secagg.protocol import RoundProtocol as JProto  # noqa: E402
from repro_torch.core import streams as tse  # noqa: E402
from repro_torch.core.types import SecureAggConfig as TSA  # noqa: E402
from repro_torch.secagg.protocol import RoundProtocol as TProto  # noqa: E402


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(torch_t, jax_a):
    np.testing.assert_array_equal(_bits(torch_t.cpu().numpy()), _bits(jax_a))


@pytest.mark.parametrize("seed,rows,n,hi", [(0, 4, 50, 10), (1, 3, 200, 500),
                                            (2, 2, 9, 2)])
def test_first_occurrence_rows_bit_exact(seed, rows, n, hi):
    idx = np.random.RandomState(seed).randint(0, hi, (rows, n)).astype(
        np.int32)
    want = np.asarray(jse.first_occurrence_rows(jnp.asarray(idx)))
    got = tse.first_occurrence_rows(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_select_topk_rows_tie_order():
    rs = np.random.RandomState(4)
    acc = rs.choice([0.0, 1.0, -1.0, 2.0, -2.0, 3.0], (6, 40)).astype(
        np.float32)
    acc[1] = 0.0                                   # an all-zero row
    acc[2, :7] = [0, 3, 1, 3, 0, 3, 2]
    acc[2, 7:] = 0.0
    acc[3] = -0.0                                  # signed zeros tie too
    for k in (1, 4, 13, 40):
        want = np.asarray(jse.select_topk_rows(jnp.asarray(acc), k, "exact",
                                               0.01))
        got = tse.select_topk_rows(torch.from_numpy(acc), k).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tse.select_topk_rows(torch.from_numpy(acc[2:3, :7]), 4).numpy(),
        [[1, 3, 5, 6]])


def _protocols(parts, round_t, mask_ratio=0.01, threshold=0.6, seed=0x5EC0DE):
    js = JSA(mask_ratio=mask_ratio, threshold=threshold, seed=seed)
    ts = TSA(mask_ratio=mask_ratio, threshold=threshold, seed=seed)
    return (js, JProto.setup(js, parts, round_t),
            ts, TProto.setup(ts, parts, round_t))


@pytest.mark.parametrize("C,nb,k_mask,m,leaf_id", [(5, 1, 313, 156800, 1),
                                                   (3, 2, 7, 101, 0),
                                                   (4, 1, 3, 9, 5)])
def test_mask_streams_all_pairs_bit_exact(C, nb, k_mask, m, leaf_id):
    _, jp, _, tp = _protocols(list(range(2, 2 + 2 * C, 2)), 3)
    js, jsg = jp.pair_seed_matrix()
    ts, tsg = tp.pair_seed_matrix()
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))
    ji, jv = jse.mask_streams_all_pairs(js, jsg, nb, k_mask, m, p=-1.0, q=2.0,
                                        leaf_id=leaf_id)
    ti, tv = tse.mask_streams_all_pairs(ts, tsg, nb, k_mask, m, p=-1.0,
                                        q=2.0, leaf_id=leaf_id)
    _assert_bits(ti, ji)
    _assert_bits(tv, jv)


# (C, size, k, mask_ratio, weights, leaf_id)
ENCODE_CASES = [
    (5, 1000, 37, 0.05, None, 1),
    (4, 777, 20, 0.1, [1.0, 2.0, 3.5, 0.5], 2),
    (3, 9, 4, 1.0, None, 0),             # heavy collisions (asserted below)
    (5, 200, 10, 0.0, None, 0),          # secure aggregation off
]


def _encode_both(C, size, k, mask_ratio, weights, leaf_id, seed=0):
    rs = np.random.RandomState(seed + size)
    upd = (rs.randn(C, size) * 0.01).astype(np.float32)
    res = (rs.randn(C, size) * 0.005).astype(np.float32)
    parts = list(range(1, C + 1))
    jsa, jp, tsa, tp = _protocols(parts, 2, mask_ratio=max(mask_ratio, 1e-9))
    km = jsa.k_mask_for(size, C) if mask_ratio > 0 else 0
    js, jsg = jp.pair_seed_matrix()
    ts, tsg = tp.pair_seed_matrix()
    w = None if weights is None else np.asarray(weights, np.float32)
    jst, jres = jse.encode_leaf_batch(
        jnp.asarray(upd), jnp.asarray(res), k=k, nb=1, m=size, size=size,
        pair_seeds=js if km else None, pair_signs=jsg if km else None,
        k_mask=km, mask_p=-1.0, mask_q=2.0, leaf_id=leaf_id,
        weights=None if w is None else jnp.asarray(w))
    tst, tres = tse.encode_leaf_batch(
        torch.from_numpy(upd), torch.from_numpy(res), k=k, nb=1, m=size,
        size=size, pair_seeds=ts if km else None,
        pair_signs=tsg if km else None, k_mask=km, mask_p=-1.0, mask_q=2.0,
        leaf_id=leaf_id, weights=None if w is None else torch.from_numpy(w))
    return dict(km=km, jst=jst, jres=jres, tst=tst, tres=tres, jp=jp, tp=tp,
                jsg=jsg, tsg=tsg, parts=parts)


@pytest.mark.parametrize("case", ENCODE_CASES,
                         ids=["uniform", "weighted", "collide", "no_sa"])
def test_encode_decode_leaf_batch_bit_exact(case):
    C, size, k, mask_ratio, weights, leaf_id = case
    r = _encode_both(*case)
    if (C, size, k) == (3, 9, 4):
        assert r["km"] * (C - 1) + k > size          # unions MUST collide
        idx = r["tst"].indices.numpy()
        assert any(len(np.unique(idx[c, 0])) < idx.shape[-1]
                   for c in range(C))
    _assert_bits(r["tst"].indices, r["jst"].indices)
    _assert_bits(r["tst"].values, r["jst"].values)
    _assert_bits(r["tres"], r["jres"])
    jd = jse.decode_leaf_batch(r["jst"], nb=1, m=size, size=size)
    td = tse.decode_leaf_batch(r["tst"], nb=1, m=size, size=size)
    _assert_bits(td, jd)


@pytest.mark.parametrize("case", ENCODE_CASES[:3],
                         ids=["uniform", "weighted", "collide"])
def test_decode_dropout_recovery_bit_exact(case):
    C, size, k, mask_ratio, weights, leaf_id = case
    r = _encode_both(*case, seed=9)
    alive = np.ones(C, bool)
    alive[-1] = False
    if C > 4:
        alive[1] = False
    surv = [p for p, a in zip(r["parts"], alive) if a]
    drop = [p for p, a in zip(r["parts"], alive) if not a]
    jrec = r["jp"].recover_seeds(surv, drop)
    trec = r["tp"].recover_seeds(surv, drop)
    np.testing.assert_array_equal(trec.numpy().astype(np.uint32),
                                  np.asarray(jrec))
    jd = jse.decode_leaf_batch(
        r["jst"], nb=1, m=size, size=size, alive=jnp.asarray(alive),
        pair_seeds=jrec, pair_signs=r["jsg"], k_mask=r["km"], mask_p=-1.0,
        mask_q=2.0, leaf_id=leaf_id)
    td = tse.decode_leaf_batch(
        r["tst"], nb=1, m=size, size=size, alive=torch.from_numpy(alive),
        pair_seeds=trec, pair_signs=r["tsg"], k_mask=r["km"], mask_p=-1.0,
        mask_q=2.0, leaf_id=leaf_id)
    _assert_bits(td, jd)
    # recovery cancels the survivors' masks toward the dropped clients:
    # the decode equals the survivors' unmasked weighted sparse sum, up to
    # the rounding of gradient values added under masks on the 2^-24 grid
    rs = np.random.RandomState(9 + size)
    upd = (rs.randn(C, size) * 0.01).astype(np.float32)
    res = (rs.randn(C, size) * 0.005).astype(np.float32)
    w = np.ones(C, np.float32) if weights is None else np.float32(weights)
    idx = r["tst"].indices.numpy()[:, 0].astype(np.int64)
    first = tse.first_occurrence_rows(torch.from_numpy(idx)).numpy()
    want = np.zeros(size, np.float64)
    for c in np.flatnonzero(alive):
        np.add.at(want, idx[c], w[c] * (res[c] + upd[c])[idx[c]] * first[c])
    np.testing.assert_allclose(td.numpy(), want, rtol=0, atol=1e-6)


def test_block_layout_and_views():
    assert tse.block_layout(10, 4) == jse.block_layout(10, 4)
    assert tse.block_layout(1000, 4) == jse.block_layout(1000, 4)
    x = np.arange(10, dtype=np.float32)
    nb, m, _ = tse.block_layout(10, 3)
    tb = tse.to_blocks(torch.from_numpy(x), nb, m)
    np.testing.assert_array_equal(tb.numpy(),
                                  np.asarray(jse.to_blocks(jnp.asarray(x),
                                                           nb, m)))
    np.testing.assert_array_equal(tse.from_blocks(tb, 10, (2, 5)).numpy(),
                                  x.reshape(2, 5))
