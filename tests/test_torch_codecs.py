"""Port parity: the wire codecs (``repro_torch.core.codecs``), the codec stage
of the encode, codec accounting and the codec guards, against
``repro.core.codecs`` on shared numpy inputs.

* int8/int4: quantize, pack, unpack, the leaf encode (indices, values, new
  residuals) and a whole round are bit-equal to the reference.
* 1bit: the row scale is a mean, summed in another order by each package;
  it is held to 4 ulp relative (measured: at most 2.2e-7, about 2 ulp), and
  everything downstream of it to that tolerance.
* Conservation inside the port: decode + Σ new residuals == Σ(updates + old
  residuals) for every codec, to f32 rounding.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codecs as jc  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core import fedavg as jfa  # noqa: E402
from repro.core import streams as jse  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.sim import presets as jpresets  # noqa: E402
from repro.sim.engine import Simulation as JSim  # noqa: E402
from repro_torch.core import codecs as tc  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core import fedavg as tfa  # noqa: E402
from repro_torch.core import streams as tse  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402
from repro_torch.sim import presets as tpresets  # noqa: E402
from repro_torch.sim.engine import Simulation as TSim  # noqa: E402

QUANT = ("int8", "int4", "1bit")
# 1bit scale tolerance: |Δ| <= 4 ulp of the scale (relative 4 * 2^-23)
ULP_REL = 4 * 2.0 ** -23


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(t, j):
    np.testing.assert_array_equal(_bits(t.cpu().numpy()), _bits(j))


def _vals(shape, seed):
    rs = np.random.RandomState(seed)
    v = (rs.randn(*shape) * rs.choice([1e-3, 0.1, 3.0], shape)).astype(
        np.float32)
    v.reshape(-1, shape[-1])[0, :3] = [0.0, -0.0, 1e-30]
    return v


def test_static_sizes_match_reference():
    for m in (1, 2, 3, 10, 200, 2000, 156800, 2359296, 2**31):
        assert tc.index_width(m) == jc.index_width(m)
    for codec in QUANT:
        assert tc.value_bits(codec) == jc.value_bits(codec)
        for k, size in ((1, 10), (7880, 156800), (60199, 2359296), (33, 99)):
            assert tc.wire_bits(k, size, codec) == jc.wire_bits(k, size,
                                                                codec)
    assert tc.CODECS == jc.CODECS and tc.SCALE_BITS == jc.SCALE_BITS
    with pytest.raises(ValueError):
        tc.wire_bits(4, 10, "f32")


@pytest.mark.parametrize("codec", QUANT)
def test_quantize_rows_against_reference(codec):
    """Against the reference as its encode runs it, under ``jax.jit`` (XLA
    multiplies by the reciprocal of ``qmax`` and of ``k``): int8/int4
    bit-equal; 1bit: q equal, scale within 4 ulp."""
    v = _vals((3, 5, 257), 1)
    v[1, 2] = 0.0                                    # an all-zero row
    jq, js = jax.jit(jc.quantize_rows, static_argnums=1)(jnp.asarray(v),
                                                         codec)
    tq, ts = tc.quantize_rows(torch.from_numpy(v), codec)
    _assert_bits(tq, jq)
    if codec == "1bit":
        js = np.asarray(js)
        np.testing.assert_allclose(ts.numpy(), js, rtol=ULP_REL, atol=0)
        np.testing.assert_allclose(
            tc.dequantize_rows(tq, ts).numpy(),
            np.asarray(jc.dequantize_rows(jq, jnp.asarray(js))),
            rtol=ULP_REL, atol=0)
    else:
        _assert_bits(ts, js)
        _assert_bits(tc.dequantize_rows(tq, ts), jc.dequantize_rows(jq, js))


@pytest.mark.parametrize("codec,k,m", [("int8", 7880, 156800),
                                       ("int4", 37, 200),
                                       ("1bit", 97, 2000),
                                       ("int8", 1, 10),
                                       ("int4", 33, 33)])
def test_pack_unpack_stream_rows_bit_exact(codec, k, m):
    rs = np.random.RandomState(k + m)
    cols = np.sort(np.stack([rs.choice(m, k, replace=False)
                             for _ in range(4)]), -1).astype(np.int32)
    cols = cols.reshape(2, 2, k)
    qmax = {"int8": 127, "int4": 7}.get(codec)
    q = (rs.choice([-1, 1], cols.shape) if qmax is None
         else rs.randint(-qmax, qmax + 1, cols.shape)).astype(np.int32)
    jiw, jvw = jc.pack_stream_rows(jnp.asarray(cols), jnp.asarray(q), m=m,
                                   codec=codec)
    tiw, tvw = tc.pack_stream_rows(torch.from_numpy(cols),
                                   torch.from_numpy(q), m=m, codec=codec)
    np.testing.assert_array_equal(tiw.numpy().astype(np.uint32),
                                  np.asarray(jiw))
    np.testing.assert_array_equal(tvw.numpy().astype(np.uint32),
                                  np.asarray(jvw))
    tcols, tq = tc.unpack_stream_rows(tiw, tvw, k=k, m=m, codec=codec)
    _assert_bits(tcols, cols)
    _assert_bits(tq, q)


def _encode_pair(codec, C=4, size=1500, k=61, weights=None, seed=0):
    rs = np.random.RandomState(seed)
    upd = (rs.randn(C, 30, size // 30) * 0.01).astype(np.float32)
    res = (rs.randn(C, 30, size // 30) * 0.004).astype(np.float32)
    w = None if weights is None else np.asarray(weights, np.float32)
    jst, jres = jse.encode_leaf_batch(
        jnp.asarray(upd), jnp.asarray(res), k=k, nb=1, m=size, size=size,
        leaf_id=2, codec=codec, weights=None if w is None else jnp.asarray(w))
    tst, tres = tse.encode_leaf_batch(
        torch.from_numpy(upd), torch.from_numpy(res), k=k, nb=1, m=size,
        size=size, leaf_id=2, codec=codec,
        weights=None if w is None else torch.from_numpy(w))
    return upd, res, jst, jres, tst, tres


@pytest.mark.parametrize("codec,weights", [
    ("int8", None), ("int4", None), ("int8", [1.0, 2.0, 0.5, 3.0]),
    ("int4", [0.25, 1.0, 4.0, 1.5])])
def test_encode_leaf_batch_quantized_bit_exact(codec, weights):
    *_, jst, jres, tst, tres = _encode_pair(codec, weights=weights)
    _assert_bits(tst.indices, jst.indices)
    _assert_bits(tst.values, jst.values)
    _assert_bits(tres, jres)
    jd = jse.decode_leaf_batch(jst, nb=1, m=1500, size=1500)
    td = tse.decode_leaf_batch(tst, nb=1, m=1500, size=1500)
    _assert_bits(td, jd)


def test_encode_leaf_batch_1bit_within_scale_tolerance():
    """Indices bit-equal; values are ±scale (4 ulp); the new residuals
    differ from the reference by at most the scale's difference."""
    *_, jst, jres, tst, tres = _encode_pair("1bit", seed=5)
    _assert_bits(tst.indices, jst.indices)
    jv = np.asarray(jst.values)
    np.testing.assert_array_equal(np.sign(tst.values.numpy()), np.sign(jv))
    np.testing.assert_allclose(tst.values.numpy(), jv, rtol=ULP_REL, atol=0)
    scale_gap = np.abs(np.abs(tst.values.numpy()) - np.abs(jv)).max()
    assert np.abs(tres.numpy() - np.asarray(jres)).max() <= scale_gap + \
        np.abs(np.asarray(jres)).max() * 2.0 ** -23


@pytest.mark.parametrize("codec", ("f32",) + QUANT)
@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5, 3.0]],
                         ids=["uniform", "weighted"])
def test_codec_conservation(codec, weights):
    """decode + Σ_c w_c·new_res_c == Σ_c w_c·(update_c + old_res_c): the
    quantization error is never lost, only carried forward."""
    upd, res, _, _, tst, tres = _encode_pair(codec, weights=weights, seed=9)
    w = np.ones(4, np.float32) if weights is None else np.asarray(weights)
    dense = tse.decode_leaf_batch(tst, nb=1, m=1500, size=1500).numpy()
    lhs = dense.astype(np.float64) + np.einsum(
        "c,cn->n", w, tres.numpy().reshape(4, -1).astype(np.float64))
    rhs = np.einsum("c,cn->n", w,
                    (upd + res).reshape(4, -1).astype(np.float64))
    np.testing.assert_allclose(lhs, rhs, rtol=0, atol=1e-6)


def test_codec_wire_roundtrip_is_lossless_and_launches_pack_ops(monkeypatch):
    """Each quantized leaf encode runs one segmented pack and one segmented
    unpack call through ``ops`` (one launch each of the CUDA kernels on the
    card, over the index and the value stream), and the wire returns the
    same sorted columns and lattice values."""
    calls = {"pack": 0, "unpack": 0}
    pack, unpack = ops.bitpack_segments, ops.bitunpack_segments

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "bitpack_segments", count("pack", pack))
    monkeypatch.setattr(ops, "bitunpack_segments", count("unpack", unpack))
    rs = np.random.RandomState(3)
    vals = torch.from_numpy(rs.randn(3, 1, 50).astype(np.float32))
    gidx = torch.from_numpy(np.stack([rs.choice(400, 50, replace=False)
                                      for _ in range(3)])[:, None, :])
    for codec in QUANT:
        cols, q, scales, _ = tse.codec_wire_stage(
            gidx, vals, torch.zeros(3, 1, 400), None, 400, codec)
        cols2, vq = tse.codec_wire_roundtrip(cols, q, scales, 400, codec)
        assert torch.equal(cols2.to(torch.int64), cols)
        assert torch.equal(vq, tc.dequantize_rows(q, scales))
    assert calls == {"pack": 3, "unpack": 3}


def _costs_args():
    return dict(ks=[7880, 30, 200, 1], k_masks=[0, 0, 0, 0], n_pairs=4,
                leaf_sizes=[156800, 200, 2000, 10])


@pytest.mark.parametrize("codec", ("f32",) + QUANT)
def test_costs_codec_accounting_equal(codec):
    a = _costs_args()
    for jb, tb in ((jcosts.PAPER_BITS, tcosts.PAPER_BITS),
                   (jcosts.TPU_BITS, tcosts.TPU_BITS)):
        assert tcosts.upload_bits_sparse(
            a["ks"], a["k_masks"], a["n_pairs"], tb, codec=codec,
            leaf_sizes=a["leaf_sizes"]) == jcosts.upload_bits_sparse(
            a["ks"], a["k_masks"], a["n_pairs"], jb, codec=codec,
            leaf_sizes=a["leaf_sizes"])
        tr = tcosts.round_record(3, 159010, a["ks"], a["k_masks"], 5, tb,
                                 n_survivors=4, codec=codec,
                                 leaf_sizes=a["leaf_sizes"])
        jr = jcosts.round_record(3, 159010, a["ks"], a["k_masks"], 5, jb,
                                 n_survivors=4, codec=codec,
                                 leaf_sizes=a["leaf_sizes"])
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)


def _mlp_setup(seed=3, parts=(1, 3, 4, 7)):
    jm = jpm.PAPER_MODELS["mnist_mlp"]
    jp = jm.init(jax.random.key(seed))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tparams = {".".join(k.key for k in path): torch.from_numpy(np.array(v))
               for path, v in flat}
    rs = np.random.RandomState(seed + 1)
    jb, tb = {}, {}
    for c in parts:
        x = rs.randn(2, 8, 28, 28, 1).astype(np.float32)
        y = rs.randint(0, 10, (2, 8)).astype(np.int32)
        jb[c] = (jnp.asarray(x), jnp.asarray(y))
        tb[c] = (torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    fed = dict(n_clients=8, clients_per_round=4, local_steps=2,
               local_batch=8, local_lr=0.05, rounds=12)
    return (jm, jp, tparams, jb, tb, jtypes.FedConfig(**fed),
            ttypes.FedConfig(**fed))


@pytest.mark.parametrize("codec,dropped", [("int8", ()), ("int4", (4,))])
def test_run_round_codec_server_half_bit_exact(monkeypatch, codec, dropped):
    """The reference's deltas fed into the port's round with a quantized
    codec: parameters, residuals and CommRecords bit-equal, two rounds."""
    jm, jp, tparams, jb, tb, jfed, tfed = _mlp_setup()
    thgs = dict(s0=0.05, alpha=0.9, s_min=0.01)
    loss_j = jpm.cross_entropy_loss(jm)
    js = jfa.init_state(jp, jfed)
    ts = tfa.init_state(tparams, tfed)
    parts = sorted(jb)
    for r in range(2):
        jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                        *[jb[c] for c in parts])
        jd, jl = jfa.batched_client_update(js.params, jstack, loss_j, 2,
                                           0.05, 0.0)
        feed = ({".".join(k.key for k in path): torch.from_numpy(np.array(v))
                 for path, v in jax.tree_util.tree_flatten_with_path(jd)[0]},
                torch.from_numpy(np.array(jl)))
        monkeypatch.setattr(tfa, "batched_client_update",
                            lambda *a, **k: feed)
        js = jfa.run_round(js, jb, loss_j, jfed, jtypes.THGSConfig(**thgs),
                           jtypes.SecureAggConfig(enabled=False),
                           dropped=dropped, codec=codec)
        ts = tfa.run_round(ts, tb, None, tfed, ttypes.THGSConfig(**thgs),
                           ttypes.SecureAggConfig(enabled=False),
                           dropped=dropped, codec=codec)
        assert dataclasses.asdict(ts.comm_log[-1]) == \
            dataclasses.asdict(js.comm_log[-1])
        for path, v in jax.tree_util.tree_flatten_with_path(js.params)[0]:
            name = ".".join(k.key for k in path)
            _assert_bits(ts.params[name], v)
        for c in parts:
            for path, v in jax.tree_util.tree_flatten_with_path(
                    js.residuals[c])[0]:
                _assert_bits(ts.residuals[c][".".join(k.key for k in path)],
                             v)


def test_codec_guards_at_every_layer():
    """codec x masks (encode, round, costs, config) and codec on a dense
    round are refused, with the reference's messages."""
    z = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="secure aggregation"):
        tse.encode_leaf_batch(z, z, k=2, nb=1, m=10, size=10, k_mask=1,
                              codec="int8")
    with pytest.raises(ValueError, match="secure aggregation"):
        tcosts.upload_bits_sparse([2], [1], 1, codec="int4",
                                  leaf_sizes=[10])
    with pytest.raises(ValueError, match="secure aggregation"):
        tcosts.round_record(0, 10, [2], [1], 2, codec="1bit",
                            leaf_sizes=[10])
    with pytest.raises(ValueError, match="leaf_sizes"):
        tcosts.upload_bits_sparse([2], [0], 1, codec="int8")
    _, _, tparams, _, tb, _, tfed = _mlp_setup(seed=1)
    thgs = ttypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    loss = tpm.cross_entropy_loss(tpm.build_model("mnist_mlp"))
    with pytest.raises(ValueError, match="secure aggregation"):
        tfa.run_round(tfa.init_state(tparams, tfed), tb, loss, tfed, thgs,
                      ttypes.SecureAggConfig(enabled=True), codec="int8")
    with pytest.raises(ValueError, match="requires THGS"):
        tfa.run_round(tfa.init_state(tparams, tfed), tb, loss, tfed, None,
                      ttypes.SecureAggConfig(enabled=False), codec="int4")
    cfg = tpresets.get("table2_quick")
    with pytest.raises(ValueError, match="secure aggregation"):
        cfg.replace(codec="int8").validate()
    with pytest.raises(ValueError, match="requires THGS"):
        cfg.replace(codec="1bit", thgs=None,
                    sa=ttypes.SecureAggConfig(enabled=False)).validate()
    with pytest.raises(ValueError, match="codec must be one of"):
        cfg.replace(codec="int2").validate()


def test_sweep_configs_match_reference():
    for name in jpresets.SWEEPS:
        assert tpresets.SWEEPS[name] == jpresets.SWEEPS[name]
        jarms = jpresets.sweep_configs(name)
        tarms = tpresets.sweep_configs(name)
        assert list(tarms) == list(jarms)
        for codec in jarms:
            assert tarms[codec].to_dict() == jarms[codec].to_dict()
            tarms[codec].validate()


def test_ci_smoke_codec_run_ledger_matches_reference():
    """A ci_smoke-sized int8 run with the reference's initial parameters:
    the ledger's slot facts and bit totals are the reference's."""
    over = dict(out_json=None, codec="int8", sa=None)
    jcfg = jpresets.get("ci_smoke")
    jcfg = jcfg.replace(**{**over, "sa": dataclasses.replace(
        jcfg.sa, enabled=False)})
    tcfg = tpresets.get("ci_smoke")
    tcfg = tcfg.replace(**{**over, "sa": dataclasses.replace(
        tcfg.sa, enabled=False)})
    jres = JSim(jcfg).run(resume=False)
    init = jax.tree_util.tree_map(
        np.asarray, jpm.PAPER_MODELS[jcfg.model].init(
            jax.random.key(jcfg.seed)))
    tres = TSim(tcfg, device="cpu", init_params=init).run()
    assert [e.ks for e in tres.ledger.entries] == \
        [e.ks for e in jres.ledger.entries]
    assert [dataclasses.asdict(e) for e in tres.ledger.entries] == \
        [dataclasses.asdict(e) for e in jres.ledger.entries]
    for acct in ("paper", "tpu"):
        assert tres.ledger.totals(acct) == jres.ledger.totals(acct)
    np.testing.assert_allclose(tres.accuracies, jres.accuracies, atol=0.02)
