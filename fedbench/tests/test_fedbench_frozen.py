"""The benchmark's frozen copies agree with the port's current generator,
partition, sampler, schedules, pair masks and paper accounting, at the
``ci_smoke`` preset's sizes."""
import numpy as np
import pytest
import torch

from fedbench.frozen import accounting, datasets, federated, secagg_masks
from repro_torch.core import costs, schedules
from repro_torch.core import streams as se
from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.data import datasets as port_data
from repro_torch.data import federated as port_fed
from repro_torch.kernels import ref as kref
from repro_torch.sim import presets
from repro_torch.sim.sampler import ClientSampler

CI = presets.get("ci_smoke")
SEEDS = (0, 7, 2 ** 31 - 10_002)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_dataset(seed, name):
    x, y = datasets.make_dataset(datasets.SPECS[name], CI.n_train, seed=seed)
    px, py = port_data.make_dataset(port_data.SPECS[name], CI.n_train,
                                    seed=seed)
    assert np.array_equal(x, px) and np.array_equal(y, py)


@pytest.mark.parametrize("seed", SEEDS)
def test_partitions_and_batches(seed):
    _, y = datasets.make_dataset(datasets.SPECS["cifar10"], CI.n_train,
                                 seed=seed)
    x = np.arange(len(y), dtype=np.float32)[:, None]
    mine = federated.noniid_label_k(y, CI.n_clients, CI.noniid_k, seed=seed)
    port = port_fed.noniid_label_k(y, CI.n_clients, CI.noniid_k, seed=seed)
    assert mine.keys() == port.keys()
    assert all(np.array_equal(mine[c], port[c]) for c in mine)
    a, b = federated.iid(y, CI.n_clients, seed=seed), port_fed.iid(
        y, CI.n_clients, seed=seed)
    assert all(np.array_equal(a[c], b[c]) for c in a)
    for c in range(CI.n_clients):
        got = federated.client_batches(x, y, mine[c], CI.local_batch,
                                       CI.local_steps, seed=seed + c)
        want = port_fed.client_batches(x, y, port[c], CI.local_batch,
                                       CI.local_steps, seed=seed + c)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("seed", SEEDS)
def test_sampler(seed):
    mine = federated.ClientSampler(CI.n_clients, CI.clients_per_round,
                                   dropout_rate=0.3, seed=seed)
    port = ClientSampler(CI.n_clients, CI.clients_per_round,
                         dropout_rate=0.3, seed=seed)
    for r in range(CI.rounds + 5):
        cohort = mine.cohort_for(r)
        assert np.array_equal(cohort, port.cohort_for(r))
        assert mine.dropouts_for(r, cohort, 2) == port.dropouts_for(
            r, cohort, 2)


SIZES = [800, 32, 25_600, 64, 102_400, 10, 4_000_000]


@pytest.mark.parametrize("t,prev,curr", [(0, None, None), (1, 2.3, 2.1),
                                         (2, 2.1, 2.4), (27, 0.5, 0.49)])
def test_schedules(t, prev, curr):
    thgs = dict(s0=0.05, alpha=0.9, s_min=0.01, time_varying=True,
                alpha_t=0.8, r_min=0.001, selector="exact", sample_frac=0.01,
                k_levels=16)
    want = schedules.leaf_ks(THGSConfig(**thgs), SIZES, t=t, total_rounds=28,
                             loss_prev=prev, loss_curr=curr)
    assert accounting.leaf_ks(thgs, SIZES, t, 28, prev, curr) == want
    sa = SecureAggConfig(mask_ratio=0.01)
    for C in (1, 2, 5):
        assert [accounting.k_mask_for(s, 0.01, C) for s in SIZES] == [
            sa.k_mask_for(s, C) for s in SIZES]


def test_paper_accounting():
    ks, kms = [40, 2, 1300, 5], [1, 1, 51, 1]
    for C, surv in ((5, 5), (4, 3), (2, 2)):
        rec = costs.round_record(3, sum(SIZES[:4]), ks, kms, n_clients=C,
                                 n_survivors=surv)
        assert accounting.round_upload_bits(
            ks, kms, n_clients=C, n_survivors=surv) == rec.upload_bits
        assert accounting.round_dense_bits(sum(SIZES[:4]), C) == \
            rec.dense_upload_bits


@pytest.mark.parametrize("round_t", [0, 5])
def test_pair_masks(round_t):
    sa = SecureAggConfig(mask_ratio=0.01, seed=12345)
    ids = [1, 4, 6, 9]
    seeds, signs = secagg_masks.seed_matrix(sa.seed, ids, round_t)
    ps, psg = se.pair_seed_matrix(sa, ids, round_t)
    assert np.array_equal(seeds, ps.numpy().astype(np.uint32))
    assert np.array_equal(signs, psg.numpy())
    for leaf_id, (size, km) in enumerate([(5000, 12), (77, 1), (1 << 20, 300)]):
        idx, mag = kref.pair_mask_segments_ref(
            ps, psg, [(1, km, size, leaf_id)], p=sa.p, q=sa.q, mirror=True)[0]
        for i in range(len(ids)):
            want = idx[i, 0].reshape(len(ids), km)
            got = secagg_masks.client_mask_support(seeds, leaf_id, i, km, size,
                                                   p=sa.p, q=sa.q)
            peers = [j for j in range(len(ids)) if j != i]
            assert np.array_equal(got, want[peers].reshape(-1).numpy())
            s = int(secagg_masks.fold_leaf_seed(seeds[i, peers[0]], leaf_id))
            _, m = secagg_masks.pair_stream(s, km, size, p=sa.p, q=sa.q)
            assert torch.equal(torch.from_numpy(m).abs(),
                               mag[i, 0, peers[0] * km:(peers[0] + 1) * km]
                               .abs())
