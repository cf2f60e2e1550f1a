"""Port parity: the distributed-DP plane (``repro_torch.core.dp``, the DP
streams of ``repro_torch.kernels.ref`` and the DP release shape of the
encode) against ``repro.core.dp`` on shared inputs.

Bit-exact: the public support stream, ``DPConfig`` seeds, ε of every round
and its composition, the encode's indices and residuals, and the ledger
slot facts of a ci_smoke-sized DP run.

To a stated tolerance:
* the noise: Box-Muller runs through PyTorch's f32 ``log``/``cos``, which
  differ from XLA's in the last bit on some inputs; after rounding to the
  2^-24 grid every value stays on the grid and moves by at most 2 grid
  steps (|Δ| <= 2 * 2^-24) at dp_quick's per-client sigma (0.245). In
  general a 1-ulp change of ``z`` moves the value by ``sigma * ulp(z)``
  before the rounding to the grid, so the bound is ``2 * (2^-24 + sigma *
  ulp(z))`` (4 grid steps were seen at sigma 0.49, the z=1.2 arm). The
  share of differing slots is measured and printed (about 3% at 0.245);
* a stream value (masks + gradient + noise): 2 grid steps, or 2 f32 ulps
  of the value where that is coarser;
* the clip factor: the norm's sum runs in another order, so the clipped
  values agree to 4 ulp relative.

Inside the port: sigma=0 / clip=inf is bit-inert, and in a dropout round
masks and noise compose exactly (decoded sum == survivors' unmasked noised
sum within 64 * 2^-24).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dp as jdp  # noqa: E402
from repro.core import streams as jse  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.sim import presets as jpresets  # noqa: E402
from repro.sim.engine import Simulation as JSim  # noqa: E402
from repro_torch.core import dp as tdp  # noqa: E402
from repro_torch.core import fedavg as tfa  # noqa: E402
from repro_torch.core import streams as tse  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402
from repro_torch.secagg.protocol import RoundProtocol as TProto  # noqa: E402
from repro_torch.sim import presets as tpresets  # noqa: E402
from repro_torch.sim.engine import Simulation as TSim  # noqa: E402

GRID = 2.0 ** -24
CLIP_ULP_REL = 4 * 2.0 ** -23   # clipped values, relative
SIGMA_DPQ = 0.6 * 1.0 / math.sqrt(6)   # dp_quick's per-client stddev


def _noise_tol(want, sigma):
    """Per-slot noise tolerance: twice the grid step plus a 1-ulp change of
    ``z`` scaled by sigma."""
    z = (np.abs(np.asarray(want, np.float64)) / sigma).astype(np.float32)
    return 2 * (GRID + sigma * np.spacing(z).astype(np.float64))


def _value_tol(want):
    """Stream values: 2 grid steps, or 2 f32 ulps where that is coarser."""
    want = np.abs(np.asarray(want, np.float32))
    return 2 * np.maximum(GRID, np.spacing(want).astype(np.float64))


def _seeds(n, seed):
    rs = np.random.RandomState(seed)
    s = rs.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s[:3] = [0, 2**32 - 1, 0x94D049BB]
    return s


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("nb,k,m", [(1, 7880, 156800), (3, 17, 101),
                                    (2, 9, 5), (1, 1, 1)])
def test_support_stream_and_common_support_bit_exact(nb, k, m):
    seeds = _seeds(6, nb * 7 + k)
    want = np.asarray(jref.dp_support_stream_ref(jnp.asarray(seeds), nb, k,
                                                 m))
    got = tref.dp_support_stream_ref(_t(seeds), nb, k, m).numpy()
    np.testing.assert_array_equal(got, want)
    for leaf_id in (0, 3):
        sup = jdp.DPConfig().support_seed(leaf_id + 5)
        np.testing.assert_array_equal(
            tdp.common_support(int(sup), nb, k, m, leaf_id).numpy(),
            np.asarray(jdp.common_support(sup, nb, k, m, leaf_id)))


@pytest.mark.parametrize("sigma", [SIGMA_DPQ, 1.2 / math.sqrt(6), 1e-3])
def test_noise_stream_on_grid_within_two_steps(sigma):
    """Every value on the 2^-24 grid; |Δ| <= 2 * 2^-24 per slot against the
    reference; the share of slots that differ is printed (measured: about
    3% at dp_quick's sigma)."""
    seeds = _seeds(25, 1)
    want = np.asarray(jref.dp_noise_stream_ref(jnp.asarray(seeds), 1, 8000,
                                               sigma=sigma))
    got = tref.dp_noise_stream_ref(_t(seeds), 1, 8000, sigma=sigma).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    steps = got.astype(np.float64) / GRID
    np.testing.assert_array_equal(steps, np.round(steps))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= _noise_tol(want, sigma)).all()
    if sigma <= SIGMA_DPQ:
        assert diff.max() <= 2 * GRID
    share = float((diff > 0).mean())
    print(f"\n[dp noise] sigma={sigma:.6f}: {share:.4%} of "
          f"{diff.size} slots differ from the reference, max "
          f"{diff.max() / GRID:.0f} grid step(s)")
    assert abs(got.std() - sigma) < 0.05 * sigma


def test_dpconfig_seeds_and_validation_match_reference():
    for kw in ({}, {"seed": 7}, {"clip": 2.0, "sigma": 0.3}):
        j, t = jdp.DPConfig(**kw), tdp.DPConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for r in (0, 1, 17):
            np.testing.assert_array_equal(
                t.client_seeds(r, [0, 5, 11]), j.client_seeds(r, [0, 5, 11]))
            assert t.support_seed(r) == j.support_seed(r)
            assert isinstance(t.support_seed(r), np.uint32)
        for c in (1, 6):
            assert t.sigma_client(c) == j.sigma_client(c)
        assert (t.clips, t.noised, t.active) == (j.clips, j.noised, j.active)
    for bad in ({"clip": 0.0}, {"sigma": -1.0}, {"sigma": 0.5},
                {"clip": 1.0, "delta": 1.0}):
        with pytest.raises(ValueError):
            jdp.DPConfig(**bad).validate()
        with pytest.raises(ValueError):
            tdp.DPConfig(**bad).validate()


def test_accountant_equals_reference_and_frontier_epsilons():
    for z in (0.0, 0.3, 0.6, 1.2, 0.6 * math.sqrt(5 / 6)):
        for a in tdp.RDP_ALPHAS:
            assert tdp.gaussian_rdp(z, a) == jdp.gaussian_rdp(z, a)
        assert tdp.round_epsilon(z, 1e-5) == jdp.round_epsilon(z, 1e-5)
    zs = [0.6, 0.6 * math.sqrt(5 / 6), 0.6, 1.2]
    assert tdp.compose_epsilon(zs, 1e-5) == jdp.compose_epsilon(zs, 1e-5)
    assert tdp.compose_epsilon([], 1e-5) == 0.0
    assert tdp.RDP_ALPHAS == jdp.RDP_ALPHAS
    # dp_frontier_quick: no dropout, 8 rounds, so eps is a function of z
    arms = tpresets.dp_sweep_configs("dp_frontier_quick")
    eps = {label: round(tdp.compose_epsilon([cfg.dp.sigma] * cfg.rounds,
                                            cfg.dp.delta), 1)
           for label, cfg in arms.items() if cfg.dp is not None}
    assert eps == {"z0.3": 89.7, "z0.6": 33.7, "z1.2": 14.1}
    jarms = jpresets.dp_sweep_configs("dp_frontier_quick")
    assert {k: v.to_dict() for k, v in arms.items()} == \
        {k: v.to_dict() for k, v in jarms.items()}
    assert tpresets.DP_SWEEPS == jpresets.DP_SWEEPS


def test_clip_client_updates_within_4_ulp():
    rs = np.random.RandomState(2)
    shapes = {"l0.w": (4, 784, 20), "l0.b": (4, 20), "l1.w": (4, 20, 10)}
    tree = {n: (rs.randn(*s) * 0.05).astype(np.float32)
            for n, s in shapes.items()}
    tree["l0.w"][1] *= 1e-3                          # one client in bound
    jtree = {"l0": {"w": tree["l0.w"], "b": tree["l0.b"]},
             "l1": {"w": tree["l1.w"]}}
    jout = jdp.clip_client_updates(
        jax.tree_util.tree_map(jnp.asarray, jtree), clip=1.0)
    tout = tdp.clip_client_updates(
        {n: torch.from_numpy(v) for n, v in tree.items()}, clip=1.0)
    for name in shapes:
        o, i = name.split(".")
        want = np.asarray(jout[o][i])
        np.testing.assert_allclose(tout[name].numpy(), want,
                                   rtol=CLIP_ULP_REL, atol=0)
        np.testing.assert_array_equal(tout[name][1].numpy(), tree[name][1])
    norms = np.sqrt(sum((tout[n].numpy().reshape(4, -1).astype(np.float64)
                         ** 2).sum(1) for n in shapes))
    assert (norms <= 1.0 + 1e-6).all()


def _dp_encode_both(C=5, size=2000, k=40, mask_ratio=0.02, leaf_id=2):
    rs = np.random.RandomState(11)
    upd = (rs.randn(C, size) * 0.01).astype(np.float32)
    res = np.zeros((C, size), np.float32)
    parts = list(range(2, 2 + C))
    sa = ttypes.SecureAggConfig(mask_ratio=mask_ratio)
    proto = TProto.setup(sa, parts, 4)
    ts, tsg = proto.pair_seed_matrix()
    km = sa.k_mask_for(size, C)
    cfg = tdp.DPConfig(clip=1.0, sigma=0.6)
    seeds = cfg.client_seeds(4, parts)
    sup = cfg.support_seed(4)
    sigma = cfg.sigma_client(C)
    jst, jres = jse.encode_leaf_batch(
        jnp.asarray(upd), jnp.asarray(res), k=k, nb=1, m=size, size=size,
        pair_seeds=jnp.asarray(ts.numpy().astype(np.uint32)),
        pair_signs=jnp.asarray(tsg.numpy()), k_mask=km, leaf_id=leaf_id,
        dp_sigma=sigma, dp_seeds=jnp.asarray(seeds), dp_support_seed=sup)
    tst, tres = tse.encode_leaf_batch(
        torch.from_numpy(upd), torch.from_numpy(res), k=k, nb=1, m=size,
        size=size, pair_seeds=ts, pair_signs=tsg, k_mask=km,
        leaf_id=leaf_id, dp_sigma=sigma, dp_seeds=_t(seeds),
        dp_support_seed=int(sup))
    return dict(upd=upd, k=k, km=km, sup=sup, jst=jst, jres=jres, tst=tst,
                tres=tres, size=size)


def test_encode_dp_release_shape_against_reference():
    """Indices (public support + mask supports) and residuals bit-equal;
    values within the noise tolerance; the data slots are the public
    support; the self slots keep their counter-drawn index (no top-1
    override under DP); mask slots carry no gradient."""
    r = _dp_encode_both()
    ti = r["tst"].indices.numpy()
    np.testing.assert_array_equal(ti, np.asarray(r["jst"].indices))
    np.testing.assert_array_equal(r["tres"].numpy().view(np.int32),
                                  np.asarray(r["jres"]).view(np.int32))
    jv = np.asarray(r["jst"].values)
    diff = np.abs(r["tst"].values.numpy().astype(np.float64)
                  - jv.astype(np.float64))
    assert (diff <= _value_tol(jv)).all()
    sup = tdp.common_support(int(r["sup"]), 1, r["k"], r["size"], 2).numpy()
    assert (ti[:, :, :r["k"]] == sup[None]).all()
    # without noise, the stream is gradient-on-support + masks only
    z = tse.encode_leaf_batch(
        torch.from_numpy(r["upd"]), torch.zeros(5, r["size"]), k=r["k"],
        nb=1, m=r["size"], size=r["size"], leaf_id=2, dp_sigma=1e-30,
        dp_seeds=torch.zeros(5, dtype=torch.int64),
        dp_support_seed=int(r["sup"]))[0]
    assert (z.values[:, :, r["k"]:] == 0).all()


def _mlp_round_inputs(seed, parts):
    jm = jpm.PAPER_MODELS["mnist_mlp"]
    jp = jm.init(jax.random.key(seed))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tparams = {".".join(k.key for k in path): torch.from_numpy(np.array(v))
               for path, v in flat}
    rs = np.random.RandomState(seed + 1)
    tb = {c: (torch.from_numpy(rs.randn(2, 8, 28, 28, 1).astype(np.float32)),
              torch.from_numpy(rs.randint(0, 10, (2, 8)).astype(np.int64)))
          for c in parts}
    fed = ttypes.FedConfig(n_clients=8, clients_per_round=len(parts),
                           local_steps=2, local_batch=8, local_lr=0.05,
                           rounds=12)
    return tparams, tb, fed


def test_dropout_round_masks_and_noise_compose_exactly():
    """A DP round with a dropped client: the decoded sum equals the
    survivors' unmasked noised sum (public support, gradient once per
    index, noise) within 64 * 2^-24 — masks cancel, noise survives."""
    parts = [1, 2, 4, 5, 7]
    tparams, tb, fed = _mlp_round_inputs(5, parts)
    thgs = ttypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    sa = ttypes.SecureAggConfig(mask_ratio=0.01, threshold=0.6)
    cfg = tdp.DPConfig(clip=1.0, sigma=0.6)
    seen = []
    tfa.run_round(tfa.init_state(tparams, fed), tb,
                  tpm.cross_entropy_loss(tpm.build_model("mnist_mlp")), fed,
                  thgs, sa, dropped=(4,), dp=cfg,
                  leaf_hook=lambda i, n, info: seen.append(info))
    assert len(seen) == 4
    for leaf_id, info in enumerate(seen):
        k, size = info["k"], info["size"]
        acc = (info["updates"] + info["residuals"]).reshape(5, -1)
        idx = info["streams"].indices.reshape(5, -1).to(torch.int64)
        first = tse.first_occurrence_rows(idx)
        first[:, min(k, size):] = False
        vals = torch.where(first, torch.gather(acc, 1, idx), 0.0)
        noise = tdp.add_stream_noise(
            torch.zeros(5, 1, idx.shape[1]), info["dp_seeds"],
            sigma=info["dp_sigma"], leaf_id=leaf_id,
            k_data=min(k, size)).reshape(5, -1)
        alive = info["alive"]
        want = tref.stream_scatter_add_ref(idx[alive].reshape(-1),
                                           (vals + noise)[alive].reshape(-1),
                                           size)
        err = (info["dense"] - want).abs().max().item()
        assert err <= 64 * GRID, err
        assert info["k_mask"] > 0 and info["dp_sigma"] > 0


def test_sigma0_clip_inf_is_bit_inert():
    """dp=DPConfig() (clip=inf, sigma=0) gives the run without dp, bit for
    bit: parameters, residuals and ledger."""
    cfg = tpresets.get("ci_smoke").replace(out_json=None, rounds=2,
                                           dropout_rate=0.3)
    a = TSim(cfg, device="cpu")
    ra = a.run()
    b = TSim(cfg.replace(dp=tdp.DPConfig()), device="cpu")
    rb = b.run()
    assert ra.ledger.summary() == rb.ledger.summary()
    assert "privacy" not in rb.ledger.summary()
    for n in a.state.params:
        assert torch.equal(a.state.params[n].view(torch.int32),
                           b.state.params[n].view(torch.int32))
    for c in a.state.residuals:
        for n in a.state.residuals[c]:
            assert torch.equal(a.state.residuals[c][n],
                               b.state.residuals[c][n])


def test_dp_guards():
    parts = [1, 3, 4]
    tparams, tb, fed = _mlp_round_inputs(1, parts)
    thgs = ttypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    sa = ttypes.SecureAggConfig(mask_ratio=0.01)
    loss = tpm.cross_entropy_loss(tpm.build_model("mnist_mlp"))
    on = tdp.DPConfig(clip=1.0, sigma=0.5)

    def rr(**kw):
        args = dict(thgs=thgs, sa=sa)
        args.update(kw)
        return tfa.run_round(tfa.init_state(tparams, fed), tb, loss, fed,
                             args.pop("thgs"), args.pop("sa"), **args)

    with pytest.raises(ValueError, match="uniform client weights"):
        rr(dp=on, client_weights={1: 2.0, 3: 1.0, 4: 1.0})
    with pytest.raises(ValueError, match="requires THGS"):
        rr(dp=on, thgs=None, sa=ttypes.SecureAggConfig(enabled=False))
    with pytest.raises(ValueError, match="cannot carry DP noise"):
        rr(dp=on, codec="int8", sa=ttypes.SecureAggConfig(enabled=False))
    with pytest.raises(ValueError, match="finite dp.clip"):
        rr(dp=tdp.DPConfig(sigma=0.5))
    z = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="cannot carry DP noise"):
        tse.encode_leaf_batch(z, z, k=2, nb=1, m=10, size=10, codec="1bit",
                              dp_sigma=0.1,
                              dp_seeds=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="requires dp_seeds"):
        tse.encode_leaf_batch(z, z, k=2, nb=1, m=10, size=10, dp_sigma=0.1)
    base = tpresets.get("dp_quick")
    for over, msg in (({"mode": "async", "sa": ttypes.SecureAggConfig(
                          enabled=False), "dropout_rate": 0.0}, "async"),
                      ({"weight_by_data_count": True}, "weight_by_data_count"),
                      ({"codec": "int8", "sa": ttypes.SecureAggConfig(
                          enabled=False)}, "cannot carry DP noise"),
                      ({"thgs": None, "sa": ttypes.SecureAggConfig(
                          enabled=False)}, "requires THGS")):
        with pytest.raises(ValueError, match=msg):
            base.replace(**over).validate()
    base.validate()


def test_ci_smoke_dp_run_ledger_matches_reference():
    """A ci_smoke-sized DP run with the reference's initial parameters: the
    ledger's slot facts, bit totals and privacy block are the reference's
    (the noise differs by a grid step on a few slots; the k schedule does
    not move)."""
    dp_over = dict(out_json=None, dropout_rate=0.3)
    jcfg = jpresets.get("ci_smoke").replace(
        dp=jdp.DPConfig(clip=1.0, sigma=0.6), **dp_over)
    tcfg = tpresets.get("ci_smoke").replace(
        dp=tdp.DPConfig(clip=1.0, sigma=0.6), **dp_over)
    jres = JSim(jcfg).run(resume=False)
    init = jax.tree_util.tree_map(
        np.asarray, jpm.PAPER_MODELS[jcfg.model].init(
            jax.random.key(jcfg.seed)))
    tres = TSim(tcfg, device="cpu", init_params=init).run()
    assert [dataclasses.asdict(e) for e in tres.ledger.entries] == \
        [dataclasses.asdict(e) for e in jres.ledger.entries]
    assert any(e.n_survivors < e.n_clients for e in tres.ledger.entries)
    for acct in ("paper", "tpu"):
        assert tres.ledger.totals(acct) == jres.ledger.totals(acct)
    assert tres.ledger.privacy() == jres.ledger.privacy()
    assert tres.summary()["ledger"]["privacy"]["epsilon"] < math.inf
    np.testing.assert_allclose(tres.accuracies, jres.accuracies, atol=0.05)
