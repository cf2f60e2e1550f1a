"""Port parity: the host-side modules (config types, schedules, costs, the
ledger, data and partitions, the sampler, DH / seed matrices, Shamir and the
round protocol) against the JAX package, exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

from repro.core import costs as jcosts  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.secagg import protocol as jproto  # noqa: E402
from repro.secagg import shamir as jshamir  # noqa: E402
from repro.sim import ledger as jledger  # noqa: E402
from repro.sim import presets as jpresets  # noqa: E402
from repro.sim import sampler as jsampler  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import schedules as tsched  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402
from repro_torch.secagg import protocol as tproto  # noqa: E402
from repro_torch.secagg import shamir as tshamir  # noqa: E402
from repro_torch.sim import ledger as tledger  # noqa: E402
from repro_torch.sim import presets as tpresets  # noqa: E402
from repro_torch.sim import sampler as tsampler  # noqa: E402

MLP_SIZES = [200, 156800, 10, 2000]
VGG_SIZES = [64] * 4 + [512] * 18 + [256] * 4 + [3 * 3 * 3 * 64, 64] + \
    [2359296, 512] * 3 + [73728, 128, 147456, 128]


@pytest.mark.parametrize("sizes", [MLP_SIZES, VGG_SIZES], ids=["mlp", "vgg"])
def test_leaf_ks_sweep_equal(sizes):
    for name in ("table2_quick", "fig1_s001_quick", "ci_smoke"):
        jt = jpresets.get(name).thgs
        tt = tpresets.get(name).thgs
        assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
        for t in range(0, 30, 3):
            for lp, lc in ((None, None), (2.3, 1.9), (0.5, 0.51), (1.0, 0.0),
                           (0.3, 2.0)):
                assert tsched.leaf_ks(tt, sizes, t, 28, lp, lc) == \
                    jsched.leaf_ks(jt, sizes, t, 28, lp, lc)


def test_quantize_k_and_k_mask_equal():
    for size in (1, 2, 10, 200, 2000, 156800, 2359296):
        for k in (0, 1, 2, 7, 100, 7880, size, size + 1):
            for levels in (4, 16):
                assert ttypes.quantize_k(k, size, levels) == \
                    jtypes.quantize_k(k, size, levels)
    for ratio in (0.01, 0.1, 1.0):
        for thr in (0.5, 0.55, 0.6, 1.0):
            js = jtypes.SecureAggConfig(mask_ratio=ratio, threshold=thr)
            ts = ttypes.SecureAggConfig(mask_ratio=ratio, threshold=thr)
            for n in (1, 2, 5, 6, 100):
                assert ts.t_for(n) == js.t_for(n)
                for size in (10, 156800):
                    assert ts.k_mask_for(size, n) == js.k_mask_for(size, n)


def test_comm_records_and_ledger_totals_equal():
    rng = np.random.RandomState(0)
    jl, tl = jledger.CommLedger(), tledger.CommLedger()
    for r in range(6):
        ks = [int(x) for x in rng.randint(1, 500, 4)]
        kms = [int(x) for x in rng.randint(0, 40, 4)] if r % 3 else [0] * 4
        for bits_j, bits_t in ((jcosts.PAPER_BITS, tcosts.PAPER_BITS),
                               (jcosts.TPU_BITS, tcosts.TPU_BITS)):
            kw = dict(n_clients=5, n_survivors=5 - r % 2, threshold=3,
                      leaf_sizes=MLP_SIZES)
            jr = jcosts.round_record(r, 159010, ks, kms, bits=bits_j, **kw)
            tr = tcosts.round_record(r, 159010, ks, kms, bits=bits_t, **kw)
            assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        jd = jcosts.dense_round_record(r, 159010, 5, n_survivors=4)
        td = tcosts.dense_round_record(r, 159010, 5, n_survivors=4)
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        jl.record(jr)
        tl.record(tr)
        jl.record(jd)
        tl.record(td)
    assert tl.summary() == jl.summary()


@pytest.mark.parametrize("name", ["mnist", "cifar10", "fashion_mnist"])
def test_datasets_equal(name):
    for seed, train in ((0, True), (3, False)):
        jx, jy = jdata.make_dataset(jdata.SPECS[name], 64, seed=seed,
                                    train=train)
        tx, ty = tdata.make_dataset(tdata.SPECS[name], 64, seed=seed,
                                    train=train)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_partitions_and_client_batches_equal():
    _, y = jdata.make_dataset(jdata.MNIST, 1500, seed=0)
    for seed in (0, 5):
        for jp, tp in ((jfed.iid(y, 10, seed=seed), tfed.iid(y, 10, seed=seed)),
                       (jfed.noniid_label_k(y, 10, 4, seed=seed),
                        tfed.noniid_label_k(y, 10, 4, seed=seed)),
                       (jfed.dirichlet(y, 10, 0.5, seed=seed),
                        tfed.dirichlet(y, 10, 0.5, seed=seed))):
            assert sorted(jp) == sorted(tp)
            for c in jp:
                np.testing.assert_array_equal(tp[c], jp[c])
    x = np.arange(1500 * 3, dtype=np.float32).reshape(1500, 3)
    idx = jfed.noniid_label_k(y, 10, 4, seed=0)[3]
    jb = jfed.client_batches(x, y, idx, 50, 5, seed=77)
    tb = tfed.client_batches(x, y, idx, 50, 5, seed=77)
    np.testing.assert_array_equal(tb[0], jb[0])
    np.testing.assert_array_equal(tb[1], jb[1])


@pytest.mark.parametrize("mode", ["uniform", "weighted"])
def test_sampler_cohort_and_dropout_draws_equal(mode):
    weights = {c: float(10 + 3 * c) for c in range(12)}
    for seed in (0, 5, 11):
        kw = dict(mode=mode, weights=weights if mode == "weighted" else None,
                  dropout_rate=0.25, seed=seed)
        js = jsampler.ClientSampler(12, 6, **kw)
        ts = tsampler.ClientSampler(12, 6, **kw)
        for r in range(20):
            jc, tc = js.cohort_for(r), ts.cohort_for(r)
            np.testing.assert_array_equal(tc, jc)
            for keep in (1, 4):
                assert ts.dropouts_for(r, tc, keep) == js.dropouts_for(r, jc,
                                                                       keep)


def test_dh_and_seed_matrices_equal():
    for seed in (0, 0x5EC0DE):
        for u in (0, 1, 17):
            assert tmasks.dh_private(seed, u) == jmasks.dh_private(seed, u)
        assert tmasks.dh_agree(seed, 3, 8) == jmasks.dh_agree(seed, 3, 8)
        assert tmasks.dh_agree(seed, 3, 8) == tmasks.dh_agree(seed, 8, 3)
        sa_j = jtypes.SecureAggConfig(seed=seed)
        sa_t = ttypes.SecureAggConfig(seed=seed)
        assert tmasks.pair_seed(sa_t, 2, 9, 4) == jmasks.pair_seed(sa_j, 2, 9, 4)
    ids = [0, 3, 4, 9, 11]
    privs = [jmasks.dh_private(7, u) for u in ids]
    pubs = [jmasks.dh_public(x) for x in privs]
    for r in (0, 1, 12):
        js, jsg = jmasks.seed_matrix_from_keys(ids, privs, pubs, r)
        ts, tsg = tmasks.seed_matrix_from_keys(ids, privs, pubs, r)
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))
        np.testing.assert_array_equal(tsg.numpy(), np.asarray(jsg))


def test_shamir_share_and_reconstruct_equal():
    secret = jmasks.dh_private(5, 3)
    xs = [1, 2, 5, 7, 9]
    for t in (1, 3, 5):
        js = jshamir.share(secret, xs, t, tag="x")
        ts = tshamir.share(secret, xs, t, tag="x")
        assert ts == js
        pts = {x: ts[x] for x in xs[:t]}
        assert tshamir.reconstruct(pts) == secret
        assert tshamir.reconstruct(pts) == jshamir.reconstruct(pts)
    with pytest.raises(ValueError):
        tshamir.share(secret, [1, 1], 1, tag="x")
    with pytest.raises(ValueError):
        tshamir.reconstruct({1: 2, 1 + tshamir.PRIME: 3})


def test_round_protocol_and_threshold_error_equal():
    parts = [1, 4, 6, 8, 9]
    for sa_kw in (dict(), dict(threshold=0.8, seed=99)):
        jsa = jtypes.SecureAggConfig(**sa_kw)
        tsa = ttypes.SecureAggConfig(**sa_kw)
        jp = jproto.RoundProtocol.setup(jsa, parts, 3)
        tp = tproto.RoundProtocol.setup(tsa, parts, 3)
        assert (tp.t, tp.publics, tp.shares) == (jp.t, jp.publics, jp.shares)
        ts, tsg = tp.pair_seed_matrix()
        js, jsg = jp.pair_seed_matrix()
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))
        surv, drop = parts[:tp.t], parts[tp.t:]
        np.testing.assert_array_equal(
            tp.recover_seeds(surv, drop).numpy().astype(np.uint32),
            np.asarray(jp.recover_seeds(surv, drop)))
        # recovered seeds equal the encode-time seeds at survivor<->dropped
        rec = tp.recover_seeds(surv, drop).numpy()
        for i, s in enumerate(parts):
            for j, d in enumerate(parts):
                if s in surv and d in drop:
                    assert rec[i, j] == ts.numpy()[i, j]
        with pytest.raises(jproto.ThresholdError):
            jp.recover_seeds(parts[:tp.t - 1], parts[tp.t - 1:])
        with pytest.raises(tproto.ThresholdError):
            tp.recover_seeds(parts[:tp.t - 1], parts[tp.t - 1:])
