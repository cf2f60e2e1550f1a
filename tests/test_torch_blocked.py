"""Port parity: the jax.random-keyed mask path (``core/streams.py``),
``core/blocked.py``, the layout modules (``models/sharding.py``,
``launch/shardings.py``, ``launch/mesh.py``, ``launch/specs.py``), the
reference leaf view (``convert.reference_leaves``) and dense secure
aggregation, against the JAX reference.

Every comparison of the data plane is bit-equal to the jitted reference
(``pairwise_mask_rows``, the fold-in pair keys, ``dropout_cancel_streams``,
``encode_client_blocks``, ``encode_batch_blocks``' keyed branch,
``encode_leaf_blocked`` at 1, 2, 4 and 8 blocks with and without masks for
2-4 participants, ``decode_blocked_sum``); the masks cancel in the port's
own sum within the reference's bound (``tests/test_blocked.py``: rtol
1e-4, atol 1e-4). Dense secure aggregation (``table2_fedavg_quick`` with
masks, 2 rounds): the dense masks and the ledger bit-equal, the parameters
within 1e-6 (measured 9.7e-8). The FL step's exchange on mesh (2,1,2) and at
a width where a stacked slice reaches 2**20 elements is bit-equal to the
reference-built oracle of ``tests/test_torch_fl_train.py``, and the
free-running step on mesh (2,1,2) (a reference subprocess started with this
module) agrees within that file's tolerances.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import blocked as jb  # noqa: E402
from repro.core import streams as js  # noqa: E402
from repro.core.types import SecureAggConfig as JSA  # noqa: E402
from repro.core.types import THGSConfig as JTHGS  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import blocked as tb  # noqa: E402
from repro_torch.core import streams as ts  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.types import SecureAggConfig as TSA  # noqa: E402
from repro_torch.core.types import THGSConfig as TTHGS  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shardings as tshd  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_fl_train import (WIDE, ReferenceRun,  # noqa: E402
                                 _bits_equal, check_exchange,
                                 check_free_running)


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.fixture(scope="module", autouse=True)
def ref_212(tmp_path_factory):
    job = ReferenceRun((2, 1, 2), tmp_path_factory.mktemp("ref212"))
    yield job
    job.close()


# ------------------------------------------------------- keyed mask path
def test_fold_pair_keys_match_reference():
    mk_j = jax.random.fold_in(jax.random.key(5), 999)
    mk_t = threefry.fold_in(threefry.key(5), 999)
    for n in (2, 3, 4):
        kj, sj = js.fold_pair_key_matrix(mk_j, n)
        kt, st = ts.fold_pair_key_matrix(mk_t, n)
        np.testing.assert_array_equal(kt.numpy(), _kd(kj))
        assert _bits_equal(sj, st)
        for me in range(n):
            kj, sj = js.fold_pair_keys_row(mk_j, jnp.int32(me), n)
            kt, st = ts.fold_pair_keys_row(mk_t, me, n)
            np.testing.assert_array_equal(kt.numpy(), _kd(kj))
            assert _bits_equal(sj, st)       # the self slot's sign is -0.0


def test_pair_key_matrix_matches_reference():
    kj, sj = js.pair_key_matrix(JSA(mask_ratio=0.01), [3, 1, 7, 12], 2)
    kt, st = ts.pair_key_matrix(TSA(mask_ratio=0.01), [3, 1, 7, 12], 2)
    np.testing.assert_array_equal(kt.numpy(), _kd(kj))
    assert _bits_equal(sj, st)


@pytest.mark.parametrize("nb,k_mask,m,leaf_id,pq,n", [
    (1, 7, 600, None, (-1.0, 2.0), 2),
    (4, 5, 151, 3, (-1.0, 2.0), 3),
    (8, 33, 1000003, None, (-1.5, 3.0), 4),
    (3, 1, 2, 7, (-0.7, 1.3), 2),
])
def test_pairwise_mask_rows_match_reference(nb, k_mask, m, leaf_id, pq, n):
    p, q = pq
    kj, sj = js.fold_pair_keys_row(jax.random.key(2), jnp.int32(1), n)
    kt, st = ts.fold_pair_keys_row(threefry.key(2), 1, n)
    f = jax.jit(lambda k, s: js.pairwise_mask_rows(
        k, s, nb, k_mask, m, p=p, q=q, leaf_id=leaf_id))
    wi, wv = f(kj, sj)
    gi, gv = ts.pairwise_mask_rows(kt, st, nb, k_mask, m, p=p, q=q,
                                   leaf_id=leaf_id)
    assert _bits_equal(wi, gi) and _bits_equal(wv, gv)


@pytest.mark.parametrize("alive", [[True, False, True, True],
                                   [False, True, True, False]])
def test_dropout_cancel_streams_match_reference(alive):
    kj, sj = js.fold_pair_key_matrix(jax.random.key(11), 4)
    kt, st = ts.fold_pair_key_matrix(threefry.key(11), 4)
    a = np.array(alive)
    f = jax.jit(lambda k, s, al: js.dropout_cancel_streams(
        k, s, al, 3, 6, 100, p=-1.0, q=2.0, leaf_id=2))
    w = f(kj, sj, jnp.asarray(a))
    g = ts.dropout_cancel_streams(kt, st, torch.from_numpy(a), 3, 6, 100,
                                  p=-1.0, q=2.0, leaf_id=2)
    assert _bits_equal(w.indices, g.indices) and _bits_equal(w.values,
                                                             g.values)


@pytest.mark.parametrize("seed,n", [(0, 2), (1, 3), (2, 4)])
def test_encode_client_blocks_and_batch_keys_match_reference(seed, n):
    rs = np.random.RandomState(seed)
    acc = rs.randn(n, 4, 150).astype(np.float32)
    kj, sj = js.fold_pair_key_matrix(jax.random.key(seed), n)
    kt, st = ts.fold_pair_key_matrix(threefry.key(seed), n)
    f = jax.jit(lambda a, k, s: js.encode_batch_blocks(
        a, 5, pair_keys=k, pair_signs=s, k_mask=7, leaf_id=3))
    w, w_acc = f(jnp.asarray(acc), kj, sj)
    g, g_acc = ts.encode_batch_blocks(torch.from_numpy(acc), 5, pair_keys=kt,
                                      pair_signs=st, k_mask=7, leaf_id=3)
    assert _bits_equal(w.indices, g.indices)
    assert _bits_equal(w.values, g.values)
    assert _bits_equal(w_acc, g_acc)
    kr_j, sr_j = js.fold_pair_keys_row(jax.random.key(seed), jnp.int32(1), n)
    kr_t, sr_t = ts.fold_pair_keys_row(threefry.key(seed), 1, n)
    f1 = jax.jit(lambda a, k, s: js.encode_client_blocks(
        a, 5, pair_keys_row=k, pair_signs_row=s, k_mask=7))
    wi, wv, wa = f1(jnp.asarray(acc[1]), kr_j, sr_j)
    gi, gv, ga = ts.encode_client_blocks(torch.from_numpy(acc[1]), 5,
                                         pair_keys_row=kr_t,
                                         pair_signs_row=sr_t, k_mask=7)
    assert _bits_equal(wi, gi) and _bits_equal(wv, gv) and _bits_equal(wa, ga)


# ----------------------------------------------------------- core/blocked
@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("size", [10, 37, 601, 5000])
def test_encode_decode_blocked_match_reference(size, n_blocks):
    rs = np.random.RandomState(size + n_blocks)
    g = rs.randn(size).astype(np.float32)
    r = (0.1 * rs.randn(size)).astype(np.float32)
    enc = jax.jit(lambda g_, r_: jb.encode_leaf_blocked(g_, r_, 3,
                                                        n_blocks))
    sj, rj = enc(jnp.asarray(g), jnp.asarray(r))
    st, rt = tb.encode_leaf_blocked(torch.from_numpy(g), torch.from_numpy(r),
                                    3, n_blocks)
    assert _bits_equal(sj.indices, st.indices)
    assert _bits_equal(sj.values, st.values) and _bits_equal(rj, rt)
    dj = jb.decode_blocked_sum(sj.indices[None], sj.values[None], size,
                               n_blocks, weight=1.0)
    dt = tb.decode_blocked_sum(st.indices[None], st.values[None], size,
                               n_blocks, weight=1.0)
    assert _bits_equal(dj, dt)
    np.testing.assert_allclose((dt + rt).numpy(), g + r, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("n_fed", [2, 3, 4])
def test_masked_blocked_exchange_matches_reference_and_cancels(n_fed,
                                                               n_blocks):
    size, kb, km = 600, 5, 7
    rs = np.random.RandomState(n_fed * 10 + n_blocks)
    mk_j = jax.random.fold_in(jax.random.key(n_fed), 999)
    mk_t = threefry.fold_in(threefry.key(n_fed), 999)
    enc = jax.jit(lambda g_, r_, k_, me: jb.encode_leaf_blocked(
        g_, r_, kb, n_blocks, mask_key=k_, k_mask_block=km, n_peers=n_fed,
        self_id=me))
    ij, vj, it, vt, expected = [], [], [], [], np.zeros(size, np.float32)
    for me in range(n_fed):
        g = rs.randn(size).astype(np.float32)
        r = np.zeros(size, np.float32)
        sj, rj = enc(jnp.asarray(g), jnp.asarray(r), mk_j, jnp.int32(me))
        st, rt = tb.encode_leaf_blocked(
            torch.from_numpy(g), torch.from_numpy(r), kb, n_blocks,
            mask_key=mk_t, k_mask_block=km, n_peers=n_fed, self_id=me)
        assert _bits_equal(sj.indices, st.indices)
        assert _bits_equal(sj.values, st.values) and _bits_equal(rj, rt)
        ij.append(sj.indices)
        vj.append(sj.values)
        it.append(st.indices)
        vt.append(st.values)
        expected = expected + (g - rt.numpy())
    for w in (1.0, 1.0 / n_fed):
        dj = jax.jit(lambda i, v: jb.decode_blocked_sum(
            i, v, size, n_blocks, weight=w))(jnp.stack(ij), jnp.stack(vj))
        dt = tb.decode_blocked_sum(torch.stack(it), torch.stack(vt), size,
                                   n_blocks, weight=w)
        assert _bits_equal(dj, dt)
    np.testing.assert_allclose(dt.numpy() * n_fed, expected, rtol=1e-4,
                               atol=1e-4)


SPEC_CASES = [((8, 6), ("data", None)), ((8, 6), (None, "model")),
              ((4, 8, 6), (None, "data", "model")),
              ((4, 8, 6), (None, ("data", "model"), None)),
              ((3, 5), ("data", None)), ((8, 6), (None, None))]


@pytest.mark.parametrize("shape,spec", SPEC_CASES)
def test_sharding_aligned_transform_round_trip(shape, spec):
    sizes = {"pod": 2, "data": 2, "model": 2}
    want = jb.sharding_aligned_transform(shape, JP(*spec), sizes,
                                         ("data", "model"))
    got = tb.sharding_aligned_transform(shape, tsharding.P(*spec), sizes,
                                        ("data", "model"))
    assert (want is None) == (got is None)
    if got is None:
        return
    assert tuple(got[2:]) == tuple(want[2:])
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    assert _bits_equal(want[0](jnp.asarray(x)), got[0](torch.from_numpy(x)))
    back = got[1](got[0](torch.from_numpy(x)))
    np.testing.assert_array_equal(back.numpy(), x)


# ------------------------------------------- layouts, meshes and specs
def _fake(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


MESHES = [((2, 16, 16), ("pod", "data", "model"), "pod"),
          ((16, 16), ("data", "model"), None),
          ((2, 2, 2), ("pod", "data", "model"), "pod"),
          ((2, 1, 2), ("pod", "data", "model"), "pod")]


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b",
                                  "llama4_scout_17b_a16e"])
@pytest.mark.parametrize("mesh", MESHES, ids=["multipod", "pod", "debug",
                                              "212"])
def test_param_specs_and_rules_match_reference(arch, mesh):
    shape, axes, fed = mesh
    jm = _fake(shape, axes)
    tm = tmesh.LogicalMesh(shape, axes, "meta")
    jr = jmesh.logical_rules(jm, fed_axis=fed)
    tr = tmesh.logical_rules(tm, fed_axis=fed)
    assert jr == tr
    assert tmesh.logical_rules(tm, fsdp=False) == \
        jmesh.logical_rules(jm, fsdp=False)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    pshapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                     jax.random.key(0)))
    flat = jax.tree_util.tree_flatten_with_path(
        jshd.param_specs(pshapes, jr, jm),
        is_leaf=lambda x: isinstance(x, JP))[0]
    want = {".".join(k.key for k in path): tuple(sp) for path, sp in flat}
    leaves = convert.reference_leaves(ttf.init_params(tcfg, device="meta"))
    got = tshd.param_specs({lf.path: lf.shape for lf in leaves}, tr, tm)
    assert list(got) == list(want)
    assert {k: tuple(v) for k, v in got.items()} == want


def test_meshes_and_logical_axis_rules():
    m = tmesh.make_production_mesh(multi_pod=True, device="meta")
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert tmesh.make_production_mesh(device="meta").shape == {
        "data": 16, "model": 16}
    d = tmesh.make_debug_mesh(2, 2, multi_pod=True, device="meta")
    assert d.shape == {"pod": 2, "data": 2, "model": 2}
    assert tmesh.make_debug_mesh(4, 1, device="meta").shape == {
        "data": 4, "model": 1}
    rules = tmesh.logical_rules(d, fed_axis="pod")
    x = torch.zeros(2, 3)
    assert tsharding.shard(x, "batch", None) is x
    with tsharding.logical_axis_rules(d, rules):
        assert tsharding.spec("batch", None, "model") == \
            tsharding.P("data", None, "model")
        assert tuple(tsharding.param_sharding(["fsdp", "vocab"])) == \
            ("data", "model")
        assert tsharding.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank mismatch"):
            tsharding.shard(x, "batch")
    assert tsharding.spec("batch") == tsharding.P(None)
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12


@pytest.mark.parametrize("arch", ["yi_6b", "hubert_xlarge",
                                  "llama32_vision_90b"])
@pytest.mark.parametrize("name", list(jspecs.SHAPES))
def test_input_specs_match_reference(arch, name):
    jm = _fake((2, 16, 16), ("pod", "data", "model"))
    tm = tmesh.make_production_mesh(multi_pod=True, device="meta")
    jr, tr = jmesh.logical_rules(jm), tmesh.logical_rules(tm)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    shape = jspecs.SHAPES[name]
    assert dataclasses.asdict(tspecs.SHAPES[name]) == \
        dataclasses.asdict(shape)
    jcfg = jspecs.arch_for_shape(jcfg, shape)
    tcfg = tspecs.arch_for_shape(tcfg, tspecs.SHAPES[name])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if shape.kind == "decode" and (jcfg.family == "audio"
                                   or jcfg.encoder_only):
        return
    tshape = tspecs.SHAPES[name]
    if shape.kind != "decode":
        want = jax.tree_util.tree_flatten_with_path(
            jspecs.input_specs(jcfg, shape))[0]
        got = tspecs.input_specs(tcfg, tshape)
        for path, sds in want:
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            assert tuple(leaf.shape) == tuple(sds.shape)
            assert str(leaf.dtype).split(".")[-1] == str(sds.dtype)
        wp = jax.tree_util.tree_flatten_with_path(
            jspecs.input_pspecs(jcfg, shape, jr),
            is_leaf=lambda x: isinstance(x, JP))[0]
        gp = tspecs.input_pspecs(tcfg, tshape, tr)
        for path, sp in wp:
            leaf = gp
            for k in path:
                leaf = leaf[k.key]
            assert tuple(leaf) == tuple(sp)
        return
    if jcfg.family != "dense":
        return
    # dense decode: the reference stacks the layers' caches on a leading
    # axis, the port holds one cache a layer: the specs agree past it
    want = jspecs.input_pspecs(jcfg, shape, jr)
    got = tspecs.input_pspecs(tcfg, tshape, tr)
    assert tuple(got["token"]) == tuple(want["token"])
    kspec = tuple(jax.tree_util.tree_leaves(
        want["state"], is_leaf=lambda x: isinstance(x, JP))[0])[1:]
    assert tuple(got["state"][0]) == kspec


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b",
                                  "llama32_vision_90b", "zamba2_7b",
                                  "xlstm_125m", "hubert_xlarge"])
def test_reference_leaves_follow_tree_leaves_order(arch):
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    tcfg = tconfigs.reduced(tconfigs.get(arch))
    ps = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
    want = [(".".join(str(k.key) for k in p), tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(ps)[0]]
    model = ttf.init_params(tcfg, device="meta")
    leaves = convert.reference_leaves(model)
    assert [(lf.path, lf.shape) for lf in leaves] == want
    named = dict(model.named_parameters())
    for lf in leaves:
        assert len(lf.names) == int(np.prod(lf.lead, dtype=np.int64))
        assert all(tuple(named[n].shape) == lf.shape[len(lf.lead):]
                   for n in lf.names)
    sizes = [int(np.prod(s)) for _, s in want]
    thgs = TTHGS(s0=0.05, alpha=0.9, s_min=0.01)
    assert ttrain.fl_leaf_plan(sizes, thgs, 4) == jtrain.fl_leaf_plan(
        ps, JTHGS(s0=0.05, alpha=0.9, s_min=0.01), 4)
    res = ttrain.init_fl_residuals(model, 2)
    jres = jtrain.init_fl_residuals(ps, 2)
    assert [(tuple(r.shape), r.dtype) for r in res] == [
        (tuple(x.shape), torch.bfloat16)
        for x in jax.tree_util.tree_leaves(jres)]


def test_yi6b_whole_has_the_slice_layout():
    """Yi-6B on the multi-pod layout: the seven stacked matrices go slice
    by slice (32 each), the rest whole: 229 decodes a step."""
    cfg = tconfigs.get("yi_6b")
    mesh = tmesh.make_production_mesh(multi_pod=True, device="meta")
    model = ttf.init_params(cfg, device="meta")
    leaves = convert.reference_leaves(model)
    assert len(leaves) == 12
    specs = tshd.param_specs({lf.path: lf.shape for lf in leaves},
                             tmesh.logical_rules(mesh, fed_axis="pod"), mesh)
    n_units = 0
    for lf in leaves:
        lead, _ = ttrain._slice_plan(lf, specs[lf.path])
        size = int(np.prod(lf.shape))
        sliced = lead > 1 and size // lead >= 1 << 20
        assert sliced == (lf.path.startswith("blocks.")
                          and len(lf.shape) == 3), lf.path
        n_units += lead if sliced else 1
    assert n_units == 229


# ---------------------------------------------- the FL step, mesh (2,1,2)
@pytest.mark.parametrize("version,shape,env,over", [
    ("v1", (2, 1, 2), {}, {}),
    ("v2", (2, 1, 2), {"REPRO_FL_V2_GENERIC": "1"}, {}),
    ("v1", (2, 2, 1), {}, WIDE),
], ids=["v1-212", "v2-212-generic", "v1-221-wide"])
def test_exchange_with_reference_gradients_is_bit_equal_to_oracle(
        version, shape, env, over, monkeypatch):
    check_exchange(version, shape, env, over, monkeypatch)

# ------------------------------------------------ dense secure aggregation
def test_dense_masked_update_is_bit_equal():
    from repro.core import secure_agg as jsa
    from repro_torch.core import secure_agg as tsa

    x = np.random.RandomState(0).randn(33, 17).astype(np.float32)
    for sa_j, sa_t in [(JSA(mask_ratio=0.01), TSA(mask_ratio=0.01)),
                       (JSA(mask_ratio=0.01, p=-1.5, q=3.0),
                        TSA(mask_ratio=0.01, p=-1.5, q=3.0))]:
        for client, leaf in [(1, 0), (4, 3)]:
            want = jsa.dense_masked_update(jnp.asarray(x), sa_j, client,
                                           [0, 1, 4, 6], 2, leaf)
            got = tsa.dense_masked_update(torch.from_numpy(x), sa_t, client,
                                          [0, 1, 4, 6], 2, leaf)
            assert _bits_equal(want, got)


def test_dense_secure_aggregation_matches_reference():
    from repro.models import paper_models as jpm
    from repro.sim import presets as jpresets
    from repro.sim.engine import Simulation as JSim
    from repro_torch.sim import presets as tpresets
    from repro_torch.sim.engine import Simulation as TSim

    jcfg = jpresets.get("table2_fedavg_quick").replace(
        out_json=None, rounds=2, sa=JSA(mask_ratio=0.01))
    tcfg = tpresets.get("table2_fedavg_quick").replace(
        out_json=None, rounds=2, sa=TSA(mask_ratio=0.01))
    js = JSim(jcfg)
    jres = js.run(resume=False)
    init = jax.tree_util.tree_map(
        np.asarray, jpm.PAPER_MODELS[jcfg.model].init(
            jax.random.key(jcfg.seed)))
    ts = TSim(tcfg, device="cpu", init_params=init)
    tres = ts.run()
    facts = [[(e.ks, e.k_masks, e.n_clients, e.n_survivors, e.threshold)
              for e in r.ledger.entries] for r in (jres, tres)]
    assert facts[0] == facts[1]
    for acct in ("paper", "tpu"):
        assert tres.ledger.totals(acct) == jres.ledger.totals(acct)
    np.testing.assert_allclose(tres.accuracies, jres.accuracies, atol=0.02)
    for (path, want) in jax.tree_util.tree_flatten_with_path(
            js.state.params)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(ts.state.params[name].numpy(),
                                   np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=name)



# ------------------------------------- the free-running step (waits last)
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_free_running_step_matches_reference_212(ref_212, version):
    check_free_running(ref_212.result(), (2, 1, 2), version)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_topk_rows_equals_lax_top_k(seed):
    """The threshold selection (k-th largest from ``torch.topk``, ties to
    the lowest index, then a stable sort of the kept) against ``lax.top_k``:
    quantized rows (many ties at the threshold), ±inf, a NaN row (the
    full-sort path) and a row shorter than k's neighbourhood."""
    rs = np.random.RandomState(seed)
    acc = (rs.randint(-6, 7, (5, 3001)) / 4.0).astype(np.float32)
    acc[1, ::97] = np.inf
    acc[2, ::89] = -np.inf
    acc[3] = -0.0
    acc[3, 5:40:3] = 1.0
    for k in (1, 17, 400, 2999, 3001):
        want = np.asarray(js.select_topk_rows(jnp.asarray(acc), k, "exact",
                                              0.01))
        got = ts.select_topk_rows(torch.from_numpy(acc), k).numpy()
        np.testing.assert_array_equal(got, want)
    acc[4, 7] = np.nan
    want = np.asarray(js.select_topk_rows(jnp.asarray(acc), 50, "exact",
                                          0.01))
    np.testing.assert_array_equal(
        ts.select_topk_rows(torch.from_numpy(acc), 50).numpy(), want)


def test_encode_update_and_aggregate_streams_match_reference():
    """The single-client protocol path over a whole update: every leaf's
    stream (its masks towards the other participants) and the server's
    one-scatter sum, against the reference's eager functions (values equal;
    the reference's eager ``w * g * first`` may leave -0.0 in a gated slot
    where its jitted form, which the port follows, leaves +0.0)."""
    from repro.core import secure_agg as jsa
    from repro_torch.core import secure_agg as tsa

    rs = np.random.RandomState(6)
    shapes = [(40, 9), (9,), (7, 3, 2)]
    parts = [2, 5, 11]
    jthgs, tthgs = JTHGS(s0=0.1, alpha=0.9, s_min=0.05), \
        TTHGS(s0=0.1, alpha=0.9, s_min=0.05)
    ks = [12, 3, 5]
    jsa_cfg, tsa_cfg = JSA(mask_ratio=0.2), TSA(mask_ratio=0.2)
    j_streams, t_streams = [], []
    for c in parts:
        upd = [rs.randn(*s).astype(np.float32) for s in shapes]
        res = [(0.1 * rs.randn(*s)).astype(np.float32) for s in shapes]
        js_, jr = jsa.encode_update([jnp.asarray(u) for u in upd],
                                    [jnp.asarray(r) for r in res], ks, jthgs,
                                    jsa_cfg, c, parts, 3)
        ts_, tr = tsa.encode_update(
            {f"l{i}": torch.from_numpy(u) for i, u in enumerate(upd)},
            [torch.from_numpy(r) for r in res], ks, tthgs, tsa_cfg, c, parts,
            3)
        for a, b in zip(js_, ts_):
            np.testing.assert_array_equal(np.asarray(a.indices),
                                          b.indices.numpy())
            np.testing.assert_array_equal(np.asarray(a.values),
                                          b.values.numpy())
        for a, b in zip(jr, tr.values()):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        j_streams.append(js_)
        t_streams.append(ts_)
    want = jsa.aggregate_streams(j_streams, shapes, [jnp.float32] * 3)
    got = tsa.aggregate_streams(t_streams, shapes, [torch.float32] * 3)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
