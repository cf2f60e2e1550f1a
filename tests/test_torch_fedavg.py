"""Port parity: one federated round (``repro_torch.core.fedavg``) against
``repro.core.fedavg``.

* Local SGD (vmapped ``torch.func.grad_and_value``) from the same injected
  parameters and batches gives deltas and losses within rtol=1e-5,
  atol=1e-6 (f32 matmuls summed in another order).
* The server half is bit-exact: with the reference's own deltas and losses
  fed in, the port's encode / decode / update gives bit-equal parameters,
  residuals and CommRecords — with uniform and non-uniform weights, with and
  without a dropout round.
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

from repro.core import fedavg as jfa  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.core import fedavg as tfa  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402

PARTS = [1, 3, 4, 7]


def _setup(steps=2, batch=8, seed=0):
    jm = jpm.PAPER_MODELS["mnist_mlp"]
    jp = jm.init(jax.random.key(seed))
    tm = tpm.build_model("mnist_mlp")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tparams = {".".join(k.key for k in path): torch.from_numpy(np.array(v))
               for path, v in flat}
    rs = np.random.RandomState(seed + 1)
    jb, tb = {}, {}
    for c in PARTS:
        x = rs.randn(steps, batch, 28, 28, 1).astype(np.float32)
        y = rs.randint(0, 10, (steps, batch)).astype(np.int32)
        jb[c] = (jnp.asarray(x), jnp.asarray(y))
        tb[c] = (torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    return jm, jp, tm, tparams, jb, tb


def _fed(**kw):
    base = dict(n_clients=8, clients_per_round=4, local_steps=2,
                local_batch=8, local_lr=0.05, rounds=12)
    base.update(kw)
    return jtypes.FedConfig(**base), ttypes.FedConfig(**base)


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox"])
def test_local_sgd_deltas_and_losses_within_tolerance(algorithm):
    jm, jp, tm, tparams, jb, tb = _setup()
    jfed, tfed = _fed(algorithm=algorithm, prox_mu=0.1)
    mu = 0.1 if algorithm == "fedprox" else 0.0
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[jb[c] for c in PARTS])
    jd, jl = jfa.batched_client_update(jp, jstack, jpm.cross_entropy_loss(jm),
                                       2, 0.05, mu)
    tstack = tuple(torch.stack([tb[c][i] for c in PARTS]) for i in range(2))
    td, tl = tfa.batched_client_update(tparams, tstack,
                                       tpm.cross_entropy_loss(tm), 2, 0.05,
                                       mu)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    for path, v in jax.tree_util.tree_flatten_with_path(jd)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(td[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)


def test_run_round_local_sgd_matches_through_leaf_hook():
    """Inside ``run_round`` itself: the deltas each leaf encodes and the
    recorded client losses match the reference's round."""
    jm, jp, tm, tparams, jb, tb = _setup(seed=2)
    jfed, tfed = _fed()
    thgs_j = jtypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    thgs_t = ttypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    js = jfa.run_round(jfa.init_state(jp, jfed), jb,
                       jpm.cross_entropy_loss(jm), jfed, thgs_j,
                       jtypes.SecureAggConfig())
    seen = {}
    ts = tfa.run_round(tfa.init_state(tparams, tfed), tb,
                       tpm.cross_entropy_loss(tm), tfed, thgs_t,
                       ttypes.SecureAggConfig(),
                       leaf_hook=lambda i, n, info: seen.setdefault(
                           n, info["updates"].clone()))
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[jb[c] for c in PARTS])
    jd, _ = jfa.batched_client_update(jp, jstack, jpm.cross_entropy_loss(jm),
                                      2, 0.05, 0.0)
    for path, v in jax.tree_util.tree_flatten_with_path(jd)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(seen[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)
    for c in PARTS:
        np.testing.assert_allclose(ts.losses[c], js.losses[c], rtol=1e-5,
                                   atol=1e-6)
    assert len(ts.comm_log) == len(js.comm_log) == 1


@pytest.mark.parametrize("weights,dropped,sa_on", [
    (None, (), True),
    ({1: 3.0, 3: 1.0, 4: 2.0, 7: 0.5}, (), True),
    (None, (4,), True),
    ({1: 3.0, 3: 1.0, 4: 2.0, 7: 0.5}, (7,), True),
    (None, (3,), False),
], ids=["uniform", "weighted", "dropout", "weighted_dropout", "no_sa"])
def test_server_half_bit_exact_on_reference_deltas(monkeypatch, weights,
                                                   dropped, sa_on):
    """Feed the reference's deltas and losses into the port's round: new
    parameters, residuals and the CommRecord are bit-equal, two rounds in a
    row (the second with non-zero error feedback and a loss history)."""
    jm, jp, tm, tparams, jb, tb = _setup(seed=3)
    jfed, tfed = _fed()
    thgs_j = jtypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    thgs_t = ttypes.THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    sa_j = jtypes.SecureAggConfig(enabled=sa_on, mask_ratio=0.01)
    sa_t = ttypes.SecureAggConfig(enabled=sa_on, mask_ratio=0.01)
    loss_j = jpm.cross_entropy_loss(jm)
    js = jfa.init_state(jp, jfed)
    ts = tfa.init_state(tparams, tfed)
    for r in range(2):
        jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                        *[jb[c] for c in PARTS])
        jd, jl = jfa.batched_client_update(js.params, jstack, loss_j, 2,
                                           0.05, 0.0)
        feed = ({".".join(k.key for k in path): torch.from_numpy(np.array(v))
                 for path, v in jax.tree_util.tree_flatten_with_path(jd)[0]},
                torch.from_numpy(np.array(jl)))
        monkeypatch.setattr(tfa, "batched_client_update",
                            lambda *a, **k: feed)
        js = jfa.run_round(js, jb, loss_j, jfed, thgs_j, sa_j,
                           client_weights=weights, dropped=dropped)
        ts = tfa.run_round(ts, tb, None, tfed, thgs_t, sa_t,
                           client_weights=weights, dropped=dropped)
        assert dataclasses.asdict(ts.comm_log[-1]) == \
            dataclasses.asdict(js.comm_log[-1])
        for path, v in jax.tree_util.tree_flatten_with_path(js.params)[0]:
            name = ".".join(k.key for k in path)
            np.testing.assert_array_equal(
                ts.params[name].numpy().view(np.int32),
                np.asarray(v).view(np.int32), err_msg=f"round {r} {name}")
        for c in PARTS:
            for path, v in jax.tree_util.tree_flatten_with_path(
                    js.residuals[c])[0]:
                name = ".".join(k.key for k in path)
                np.testing.assert_array_equal(
                    ts.residuals[c][name].numpy().view(np.int32),
                    np.asarray(v).view(np.int32))


def test_dense_baseline_and_refusals():
    jm, jp, tm, tparams, jb, tb = _setup(seed=4)
    jfed, tfed = _fed()
    js = jfa.run_round(jfa.init_state(jp, jfed), jb,
                       jpm.cross_entropy_loss(jm), jfed, None,
                       jtypes.SecureAggConfig(enabled=False), dropped=(3,))
    ts = tfa.run_round(tfa.init_state(tparams, tfed), tb,
                       tpm.cross_entropy_loss(tm), tfed, None,
                       ttypes.SecureAggConfig(enabled=False), dropped=(3,))
    assert dataclasses.asdict(ts.comm_log[0]) == dataclasses.asdict(
        js.comm_log[0])
    for path, v in jax.tree_util.tree_flatten_with_path(js.params)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(ts.params[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)
    # dense secure aggregation: the dense Bonawitz masks agreed among the
    # survivors; the same record, the params within the dense round's
    # tolerance
    js = jfa.run_round(jfa.init_state(jp, jfed), jb,
                       jpm.cross_entropy_loss(jm), jfed, None,
                       jtypes.SecureAggConfig(mask_ratio=0.01), dropped=(3,))
    ts = tfa.run_round(tfa.init_state(tparams, tfed), tb,
                       tpm.cross_entropy_loss(tm), tfed, None,
                       ttypes.SecureAggConfig(mask_ratio=0.01), dropped=(3,))
    assert dataclasses.asdict(ts.comm_log[0]) == dataclasses.asdict(
        js.comm_log[0])
    for path, v in jax.tree_util.tree_flatten_with_path(js.params)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(ts.params[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)
