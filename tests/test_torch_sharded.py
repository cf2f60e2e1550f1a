"""Port of slice E: the client-sharded round (``run_round(mesh=...)``),
inside the port and against the JAX reference.

The shards share the CPU device (``ClientsMesh((cpu,) * n)``, the port's
counterpart of the reference's fake host devices) and run one after
another in this process.

* Sharded == serial inside the port, bit for bit in params, every
  client's residuals, ledger entries and accuracies: the reference's parity
  configuration at cohorts 6 and 8 over 2, 3, 6 and 2, 8 shards (a dropout
  round included), the tree decode over 2 and 3, the int8 / int4 / 1bit
  codecs over 2, DP at sigma 0.5 over 2, VGG16 (cohort 4, 2 rounds, secure
  aggregation, a dropout round) over 2, and a sharded run killed after
  round 2 and resumed against the uninterrupted serial run.
* Against the JAX package, as bits: ``encode_decode_leaf_sharded`` against
  the reference's serial ``encode_leaf_batch`` + ``decode_leaf_batch``, and
  ``mask_streams_rows`` against the reference's for every shard's rows.
* The mesh helpers, ``can_shard_clients``, the engine's ``shard_clients``
  modes and the ``--shard-clients`` CLI.
* On the card only (``gpu``): the pair-mask kernel's row launch against its
  plain version and the mirrored launch's rows.
"""
import functools

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
from repro.launch import mesh as jmesh  # noqa: E402
from repro.secagg.protocol import RoundProtocol as JProto  # noqa: E402
from repro_torch.core import streams as se  # noqa: E402
from repro_torch.core.dp import DPConfig  # noqa: E402
from repro_torch.core.types import (SecureAggConfig,  # noqa: E402
                                    THGSConfig)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import (ClientsMesh,  # noqa: E402
                                     clients_mesh_for, default_tree_groups,
                                     make_clients_mesh)
from repro_torch.secagg.protocol import RoundProtocol as TProto  # noqa: E402
from repro_torch.sim import presets  # noqa: E402
from repro_torch.sim.__main__ import main as sim_main  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.engine import Simulation  # noqa: E402

CPU = torch.device("cpu")


def _mesh(n):
    return ClientsMesh((CPU,) * n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(torch_t, jax_a):
    np.testing.assert_array_equal(_bits(torch_t.cpu().numpy()), _bits(jax_a))


def _teq(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


# --------------------------------------------------- sharded == serial runs
# the reference's parity configuration (tests/test_client_sharded_round.py)
_BASE = dict(
    name="parity", model="mnist_mlp", dataset="mnist", rounds=3,
    n_clients=12, n_train=600, n_test=200, local_steps=2, local_batch=16,
    eval_every=1, thgs=THGSConfig(s0=0.05, alpha=0.9, s_min=0.01),
    sa=SecureAggConfig(mask_ratio=0.02, seed=3), dropout_rate=0.4,
    weight_by_data_count=True, seed=1, shard_clients="off")
_NO_SA = dict(sa=SecureAggConfig(enabled=False))
CONFIGS = {
    "parity6": SimConfig(clients_per_round=6, **_BASE),
    "parity8": SimConfig(clients_per_round=8, **_BASE),
    "tree": SimConfig(clients_per_round=6, **_BASE).replace(
        topology="tree", tree_groups=3),
    "int8": SimConfig(clients_per_round=6, **_BASE).replace(
        codec="int8", **_NO_SA),
    "int4": SimConfig(clients_per_round=6, **_BASE).replace(
        codec="int4", **_NO_SA),
    "1bit": SimConfig(clients_per_round=6, **_BASE).replace(
        codec="1bit", **_NO_SA),
    "dp": SimConfig(clients_per_round=6, **_BASE).replace(
        weight_by_data_count=False,
        dp=DPConfig(clip=1.0, sigma=0.5, seed=11)),
    # a conv + BN model: its convolutions and batch norms run one client at
    # a time under vmap, so a shard's clients round as the cohort's
    "vgg16": SimConfig(
        name="vgg16", model="cifar_vgg16", dataset="cifar10", rounds=2,
        n_clients=4, clients_per_round=4, n_train=64, n_test=32,
        local_steps=1, local_batch=4, eval_every=1,
        thgs=THGSConfig(s0=0.05, alpha=0.9, s_min=0.01),
        sa=SecureAggConfig(mask_ratio=0.01, seed=3), dropout_rate=0.4,
        seed=1, shard_clients="off"),
}
RUNS = [("parity6", 2), ("parity6", 3), ("parity6", 6), ("parity8", 2),
        ("parity8", 8), ("tree", 2), ("tree", 3), ("int8", 2), ("int4", 2),
        ("1bit", 2), ("dp", 2), ("vgg16", 2)]


def _run(cfg, shards):
    sim = Simulation(cfg, device="cpu")
    assert sim.mesh is None
    if shards:
        sim.mesh = _mesh(shards)
    return sim, sim.run(resume=False)


@functools.lru_cache(maxsize=None)
def _serial(name):
    return _run(CONFIGS[name], 0)


def _assert_runs_equal(a, ra, b, rb):
    for n in b.state.params:
        assert _teq(a.state.params[n], b.state.params[n]), n
    assert sorted(a.state.residuals) == sorted(b.state.residuals)
    for c in b.state.residuals:
        for n in b.state.params:
            assert _teq(a.state.residuals[c][n], b.state.residuals[c][n]), \
                (c, n)
    assert ra.ledger.entries == rb.ledger.entries
    assert ra.accuracies == rb.accuracies


@pytest.mark.parametrize("name,shards", RUNS,
                         ids=[f"{n}-{s}shards" for n, s in RUNS])
def test_sharded_run_bit_equal_to_serial(name, shards):
    sim0, res0 = _serial(name)
    sim = Simulation(CONFIGS[name], device="cpu")
    sim.mesh = _mesh(shards)
    seen = []
    sim.leaf_hook = lambda leaf_id, n, info: seen.append(info["shards"])
    res = sim.run(resume=False)
    _assert_runs_equal(sim, res, sim0, res0)
    assert set(seen) == {shards}           # every leaf took the sharded path
    # the dropout path ran: at least one round lost a client
    assert any(e.n_survivors < e.n_clients for e in res.ledger.entries)


class _Killed(Exception):
    pass


def _die_after_round_2(r, info):
    if r == 1:
        raise _Killed


def test_sharded_table2_quick_killed_and_resumed_equals_serial(tmp_path):
    cfg = presets.get("table2_quick").replace(rounds=4, out_json=None)
    ckcfg = cfg.replace(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    sim = Simulation(ckcfg, device="cpu")
    sim.mesh = _mesh(5)
    with pytest.raises(_Killed):
        sim.run(hooks=[_die_after_round_2])
    resumed_sim, seen = Simulation(ckcfg, device="cpu"), []
    resumed_sim.mesh = _mesh(5)
    resumed = resumed_sim.run(hooks=[lambda r, info: seen.append(r)])
    full_sim = Simulation(cfg.replace(shard_clients="off"), device="cpu")
    full = full_sim.run()
    assert seen == [2, 3]
    _assert_runs_equal(resumed_sim, resumed, full_sim, full)
    assert resumed.losses == full.losses


# ---------------------------------------------- against the JAX reference
def _protocols(parts, round_t, mask_ratio):
    js = JSA(mask_ratio=mask_ratio, seed=0x5EC0DE)
    ts = SecureAggConfig(mask_ratio=mask_ratio, seed=0x5EC0DE)
    return js, JProto.setup(js, parts, round_t), TProto.setup(ts, parts,
                                                             round_t)


# (C, shards, nb, m, k, mask_ratio, weighted, dropped, codec, dp, topology)
LEAF_CASES = {
    "masks": (6, 3, 1, 1000, 37, 0.05, True, (), "f32", False, "flat"),
    "masks-dropout": (6, 2, 1, 777, 20, 0.1, True, (1, 4), "f32", False,
                      "flat"),
    "masks-one-a-shard": (4, 4, 1, 300, 11, 0.2, False, (2,), "f32", False,
                          "flat"),
    "tree-dropout": (6, 3, 1, 500, 25, 0.05, True, (0,), "f32", False,
                     "tree"),
    "int8": (4, 2, 3, 64, 8, 0.0, True, (), "int8", False, "flat"),
    "int4": (4, 4, 3, 64, 8, 0.0, False, (), "int4", False, "flat"),
    "1bit": (4, 2, 3, 64, 8, 0.0, True, (), "1bit", False, "flat"),
    "dp": (4, 2, 3, 64, 8, 0.0, False, (), "f32", True, "flat"),
    "dp-masks": (6, 3, 1, 400, 12, 0.05, False, (5,), "f32", True, "flat"),
}


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_encode_decode_leaf_sharded_bit_equal_to_reference(case):
    """The port's sharded leaf against the reference's SERIAL encode +
    decode on the same numpy inputs: the decoded sum and the new residuals
    as bits."""
    (C, shards, nb, m, k, mask_ratio, weighted, dropped, codec, dp_on,
     topology) = LEAF_CASES[case]
    size = nb * m - (3 if nb > 1 else 0)
    rs = np.random.RandomState(len(case) + 7 * C + size)
    upd = (rs.randn(C, size) * 0.01).astype(np.float32)
    res = (rs.randn(C, size) * 0.005).astype(np.float32)
    w = (rs.uniform(0.5, 3.0, C).astype(np.float32) if weighted
         else np.ones(C, np.float32))
    parts = list(range(1, C + 1))
    km = 0
    jkw, tkw = {}, {}
    if mask_ratio > 0:
        jsa, jp, tp = _protocols(parts, 2, mask_ratio)
        km = jsa.k_mask_for(m, C)
        js, jsg = jp.pair_seed_matrix()
        ts, tsg = tp.pair_seed_matrix()
        jkw.update(pair_seeds=js, pair_signs=jsg, k_mask=km)
        tkw.update(pair_seeds=ts, pair_signs=tsg, k_mask=km)
    if dp_on:
        dpc = DPConfig(clip=1.0, sigma=0.5, seed=11)
        seeds = dpc.client_seeds(0, parts)
        sup = int(dpc.support_seed(0))
        jkw.update(dp_sigma=0.01, dp_support_seed=np.uint32(sup),
                   dp_seeds=jnp.asarray(seeds))
        tkw.update(dp_sigma=0.01, dp_support_seed=sup,
                   dp_seeds=torch.from_numpy(seeds.astype(np.int64)))
    leaf_id = 3
    jst, jres = jse.encode_leaf_batch(
        jnp.asarray(upd), jnp.asarray(res), k=k, nb=nb, m=m, size=size,
        leaf_id=leaf_id, weights=jnp.asarray(w), codec=codec, **jkw)
    alive = np.array([p - 1 not in dropped for p in parts])
    dkw = {}
    tdkw = {}
    if dropped:
        dkw["alive"] = jnp.asarray(alive)
        tdkw["alive"] = torch.from_numpy(alive)
        if km:
            surv = [p for p, a in zip(parts, alive) if a]
            drop = [p for p, a in zip(parts, alive) if not a]
            dkw.update(pair_seeds=jp.recover_seeds(surv, drop),
                       pair_signs=jsg, k_mask=km)
            tdkw.update(recovery_seeds=tp.recover_seeds(surv, drop))
    if topology == "tree":
        splits = jse.tree_splits(nb * m, 3)
        jd = jse.decode_leaf_tree(jst, nb=nb, m=m, size=size, splits=splits,
                                  leaf_id=leaf_id, **dkw)
    else:
        jd = jse.decode_leaf_batch(jst, nb=nb, m=m, size=size,
                                   leaf_id=leaf_id, **dkw)
    td, tres, tst = se.encode_decode_leaf_sharded(
        _mesh(shards), torch.from_numpy(upd), torch.from_numpy(res), k=k,
        nb=nb, m=m, size=size, leaf_id=leaf_id, weights=torch.from_numpy(w),
        codec=codec, topology=topology, tree_groups=3, **tkw, **tdkw)
    _assert_bits(td, jd)
    _assert_bits(tres, jres)
    # the gathered stream is the serial encode's, in client order
    _assert_bits(tst.indices, jst.indices)
    _assert_bits(tst.values, jst.values)


# (C, c_loc, nb, k_mask, m, leaf_id)
ROW_CASES = [(6, 2, 1, 17, 1000, 1), (6, 3, 2, 5, 101, 0),
             (5, 1, 1, 31, 2000, 7), (8, 4, 1, 3, 9, None)]


@pytest.mark.parametrize("C,c_loc,nb,k_mask,m,leaf_id", ROW_CASES)
def test_mask_streams_rows_bit_equal_to_reference(C, c_loc, nb, k_mask, m,
                                                  leaf_id):
    """Every shard's rows, against the reference's ``mask_streams_rows``
    and against the rows of the port's mirrored full-matrix pass (the seed
    fold reads each seed at its global pair)."""
    _, jp, tp = _protocols(list(range(3, 3 + C)), 4, 0.01)
    js, jsg = jp.pair_seed_matrix()
    ts, tsg = tp.pair_seed_matrix()
    whole = se.mask_streams_all_pairs(ts, tsg, nb, k_mask, m, p=-1.0, q=2.0,
                                      leaf_id=leaf_id)
    seeds_d, signs_d = se.round_matrices(CPU, ts, tsg)
    for i0 in range(0, C, c_loc):
        rows = slice(i0, i0 + c_loc)
        ji, jv = jse.mask_streams_rows(js[rows], jsg[rows], nb, k_mask, m,
                                       p=-1.0, q=2.0, leaf_id=leaf_id)
        ti, tv = se.mask_streams_rows(ts[rows], tsg[rows], nb, k_mask, m,
                                      p=-1.0, q=2.0, leaf_id=leaf_id)
        _assert_bits(ti, ji)
        _assert_bits(tv, jv)
        assert _teq(ti, whole[0][rows]) and _teq(tv, whole[1][rows])
        # the round form over the int32 lanes of round_matrices, one leaf
        # of several
        got = se.mask_streams_rows_round(
            seeds_d[rows], signs_d[rows],
            [(1, 2, 50, 0), (nb, k_mask, m, leaf_id)], p=-1.0, q=2.0)
        assert _teq(got[1][0], ti) and _teq(got[1][1], tv)


# --------------------------------------------------------------- the mesh
def test_can_shard_clients_gates():
    assert not se.can_shard_clients(None, 8)
    assert not se.can_shard_clients(make_clients_mesh(1, device_type="cpu"),
                                    8)
    assert se.can_shard_clients(_mesh(2), 8)
    assert not se.can_shard_clients(_mesh(2), 7)      # indivisible cohort
    assert not se.can_shard_clients(_mesh(1), 8)      # one shard: serial
    assert se.can_shard_clients(_mesh(8), 8)
    assert not se.can_shard_clients(object(), 8)      # not a clients mesh


def test_mesh_helpers():
    assert _mesh(3).size == 3 and _mesh(3).axis_name == se.CLIENT_AXIS
    assert make_clients_mesh(device_type="cpu").devices == (CPU,)
    with pytest.raises(ValueError):
        make_clients_mesh(2, device_type="cpu")
    with pytest.raises(ValueError):
        make_clients_mesh(0, device_type="cpu")
    assert clients_mesh_for(6, device_type="cpu") is None
    if not torch.cuda.is_available():
        assert clients_mesh_for(6) is None
        with pytest.raises(ValueError):
            make_clients_mesh(1)
    for c in (1, 2, 4, 5, 9, 64, 1000):
        assert default_tree_groups(c) == jmesh.default_tree_groups(c)
    shards = se.shard_client_tree(
        {"a": torch.arange(12).reshape(6, 2), "b": (torch.arange(6),)},
        _mesh(3))
    assert [s["b"][0].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5]]
    back = se.all_gather_round(shards, CPU)
    assert torch.equal(back["a"], torch.arange(12).reshape(6, 2))
    order = se.shard_map_clients(lambda i0, dev, x: (i0, x["b"][0].tolist()),
                                 _mesh(3), 6, shards)
    assert order == [(0, [0, 1]), (2, [2, 3]), (4, [4, 5])]
    with pytest.raises(ValueError):
        se.shard_client_tree({"a": torch.zeros(5)}, _mesh(2))


def test_shard_clients_modes_on_one_device():
    cfg = presets.get("ci_smoke").replace(rounds=1, out_json=None)
    with pytest.raises(RuntimeError, match="1 cpu device"):
        Simulation(cfg.replace(shard_clients="on"), device="cpu")
    cfg.replace(shard_clients="on").validate()        # no longer refused
    runs = []
    for mode in ("off", "auto"):
        sim = Simulation(cfg.replace(shard_clients=mode), device="cpu")
        assert sim.mesh is None
        runs.append((sim, sim.run(resume=False)))
    _assert_runs_equal(*runs[0], *runs[1])
    with pytest.raises(ValueError, match="async"):
        presets.get("async_quick").replace(shard_clients="on").validate()


def test_shard_clients_cli(capsys):
    argv = ["--preset", "ci_smoke", "--device", "cpu", "--rounds", "1",
            "--out", "/dev/null"]
    assert sim_main(argv + ["--shard-clients", "on"]) == 1
    err = capsys.readouterr().err
    assert "shard_clients='on'" in err and "1 cpu device" in err
    assert sim_main(argv + ["--shard-clients", "off"]) == 0
    out = capsys.readouterr().out
    assert "clients_mesh" not in out and "final_acc=" in out


@pytest.mark.parametrize("name,shards", [("parity6", 3), ("int8", 2),
                                         ("dp", 2)])
def test_leaf_hook_sees_the_same_leaf_on_both_paths(name, shards,
                                                    monkeypatch):
    """The sharded round's leaves go through ``encode_decode_leaf_sharded``,
    and the leaf hook is called at the same point on both paths: the same
    updates, streams, decoded sum and new residuals (before the dropped
    clients' carry), as bits."""
    calls = []
    real = se.encode_decode_leaf_sharded
    monkeypatch.setattr(se, "encode_decode_leaf_sharded",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = CONFIGS[name].replace(rounds=2)
    seen = []
    for mesh in (None, _mesh(shards)):
        log = []
        sim = Simulation(cfg, device="cpu")
        sim.mesh = mesh
        sim.leaf_hook = lambda leaf_id, n, info, log=log: log.append(info)
        sim.run(resume=False)
        seen.append(log)
    assert len(calls) == len(seen[1]) == len(seen[0]) == 2 * 4
    for a, b in zip(*seen):
        for key in ("updates", "residuals", "dense", "new_residuals"):
            assert _teq(a[key], b[key]), key
        assert _teq(a["streams"].indices, b["streams"].indices)
        assert _teq(a["streams"].values, b["streams"].values)
        assert (a["shards"], b["shards"]) == (1, shards)


def test_sharded_leaf_takes_precomputed_masks_and_recovery():
    """``masks=`` (each shard's row launch) and ``recovery=`` (the round's
    recovery streams) give the leaf that the seeds give."""
    C, shards, m, k, leaf_id = 6, 3, 500, 20, 2
    rs = np.random.RandomState(5)
    upd = torch.from_numpy((rs.randn(C, m) * 0.01).astype(np.float32))
    res = torch.from_numpy((rs.randn(C, m) * 0.005).astype(np.float32))
    parts = list(range(1, C + 1))
    sa, _, tp = _protocols(parts, 1, 0.05)
    km = sa.k_mask_for(m, C)
    seeds, signs = tp.pair_seed_matrix()
    alive = torch.tensor([p not in (2, 5) for p in parts])
    rec = tp.recover_seeds([p for p in parts if p not in (2, 5)], [2, 5])
    kw = dict(k=k, nb=1, m=m, size=m, k_mask=km, leaf_id=leaf_id,
              pair_signs=signs, alive=alive)
    a = se.encode_decode_leaf_sharded(_mesh(shards), upd, res,
                                      pair_seeds=seeds, recovery_seeds=rec,
                                      **kw)
    sd, gd = se.round_matrices(CPU, seeds, signs)
    leaf = [(1, km, m, leaf_id)]
    c_loc = C // shards
    masks = [se.mask_streams_rows_round(sd[i:i + c_loc], gd[i:i + c_loc],
                                        leaf, p=-1.0, q=2.0)[0]
             for i in range(0, C, c_loc)]
    recovery = se.recovery_streams_round(rec, signs, alive, leaf, p=-1.0,
                                         q=2.0)[0]
    b = se.encode_decode_leaf_sharded(_mesh(shards), upd, res, masks=masks,
                                      recovery=recovery, **kw)
    for x, y in zip(a[:2] + tuple(a[2]), b[:2] + tuple(b[2])):
        assert _teq(x, y)


def test_run_round_on_a_mesh_that_cannot_shard_is_serial():
    """A mesh whose size does not divide the cohort runs the serial round
    (``can_shard_clients`` false), bit for bit."""
    cfg = CONFIGS["parity6"].replace(rounds=1)
    sim0, res0 = _run(cfg, 0)
    sim, res = _run(cfg, 4)
    _assert_runs_equal(sim, res, sim0, res0)


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_cuda_row_launch_bit_equal_to_plain_and_mirrored_rows():
    """The pair-mask kernel with ``rows = C_loc < peers = C``, no mirror, at
    mnist_mlp's 4 leaves: one launch a shard, bit-equal to its plain version
    and to the rows of the mirrored round launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "with no CPU mode")
    from repro_torch.kernels import mask_prng

    dev = torch.device("cuda")
    C = 6
    sa = SecureAggConfig(mask_ratio=0.01)
    proto = TProto.setup(sa, list(range(C)), 3)
    seeds, signs = proto.pair_seed_matrix()
    sizes = [156800, 200, 2000, 10]
    leaves = [(1, sa.k_mask_for(n, C), n, i) for i, n in enumerate(sizes)]
    sd, gd = se.round_matrices(dev, seeds, signs)
    whole = se.mask_streams_round(sd, gd, leaves, p=-1.0, q=2.0)
    for c_loc in (1, 2, 3):
        before = mask_prng.launches
        for i0 in range(0, C, c_loc):
            rows = slice(i0, i0 + c_loc)
            got = se.mask_streams_rows_round(sd[rows], gd[rows], leaves,
                                             p=-1.0, q=2.0)
            plain = ref.pair_mask_segments_ref(sd[rows], gd[rows], leaves)
            for (i, v), (pi, pv), (wi, wv) in zip(got, plain, whole):
                assert _teq(i, pi) and _teq(v, pv)
                assert _teq(i, wi[rows]) and _teq(v, wv[rows])
        assert mask_prng.launches - before == C // c_loc
