"""Port parity: the federated LM train step (``launch/train.py``'s
``make_fl_train_step`` and ``_v2``), dense secure aggregation and the
``fl_train`` CLI, against the JAX reference.

* **The exchange, bit for bit.** Each participant's gradients come from
  ``jax.value_and_grad`` of the reference's loss on its rows; they go into
  the port's exchange stage and into an oracle assembled from the
  reference's own ``encode_leaf_blocked`` / ``decode_blocked_sum`` (v1, the
  slice path and its per-slice keys included) or ``encode_batch_blocks``
  (v2), jitted as the step runs them. Streams, residuals and parameters are
  bit-equal, on mesh (2,2,1) with the generic and the aligned layouts
  (``tests/test_torch_blocked.py`` holds mesh (2,1,2) and a width where a
  stacked slice reaches 2**20 elements).
* **The free-running step** against the reference's real step, run in a
  subprocess on 4 fake CPU devices over an Auto-axis ``jax.sharding.Mesh``
  (started with the module, awaited by its last tests; mesh (2,1,2) runs
  in ``tests/test_torch_blocked.py``)
  (``jax.make_mesh`` builds Explicit axes, on which the reference's embed
  gather raises): reduced Yi-6B in f32, B 8 x T 32, 2 steps. The loss
  within 2e-5 (measured <= 2.4e-6); the parameters within 2e-3 (measured
  5.0e-4 on (2,2,1) v2, 9.3e-4 on (2,1,2) v2, 9.3e-5 / 1.9e-6 for v1): the
  gradients differ in the last bits (GSPMD's partial sums), which flips a
  few top-k selections, each moving one element by its whole update; the
  share of elements off by more than 1e-5 stays under 1%. The same holds
  with each participant spread over two groups on the CPU (sharded
  parameters, chunked residual rows, the gradients f32 sums of two
  halves).
* **The CLI**: the loss falls over 6 steps, a run stopped at step 3 and
  resumed replays the uninterrupted run bit for bit, and the ledger equals
  the reference example's ``step_wire_record``.
"""
import dataclasses
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import blocked as jblocked  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.core import streams as jstreams  # noqa: E402
from repro.core.types import SecureAggConfig as JSA  # noqa: E402
from repro.core.types import THGSConfig as JTHGS  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.types import SecureAggConfig as TSA  # noqa: E402
from repro_torch.core.types import THGSConfig as TTHGS  # noqa: E402
from repro_torch.launch import fsdp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
AXES = ("pod", "data", "model")
THGS = dict(s0=0.1, alpha=0.9, s_min=0.01)     # the reference test's
MASK_RATIO, LR, B, T = 0.05, 0.05, 8, 32
LOSS_TOL = 2e-5
PARAM_TOL = 2e-3
MOVED_SHARE = 0.01
WIDE = dict(d_model=1024, d_ff=1024)           # a stacked slice = 2**20

REF_SCRIPT = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.models import transformer as tf
from repro.models.sharding import logical_axis_rules
from repro.launch import shardings as shd
from repro.launch.mesh import logical_rules
from repro.launch.train import make_fl_train_step, make_fl_train_step_v2
from repro.core.types import THGSConfig, SecureAggConfig
shape, out_path, thgs, mask_ratio, lr, B, T = json.loads(sys.argv[1])
# Auto axes: jax.make_mesh builds Explicit ones, on which the embed gather
# of the reference's model raises ShardingTypeError
mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
            ("pod", "data", "model"))
cfg = dataclasses.replace(configs.reduced(configs.get("yi_6b")),
                          dtype="float32")
params = tf.init_params(cfg, jax.random.key(0))
rules = logical_rules(mesh, fed_axis="pod")
pshapes = jax.tree_util.tree_map(
    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
params = jax.device_put(params, shd.named(shd.param_specs(pshapes, rules,
                                                          mesh), mesh))
rs = np.random.RandomState(5)
batch_np = {"tokens": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32),
            "labels": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)}
batch = jax.device_put({k: jnp.asarray(v) for k, v in batch_np.items()},
                       NamedSharding(mesh, P(("pod", "data"), None)))
out = {"batch": batch_np}
for name, mk in (("v1", make_fl_train_step), ("v2", make_fl_train_step_v2)):
    step = mk(cfg, mesh, "pod", THGSConfig(**thgs),
              SecureAggConfig(mask_ratio=mask_ratio), lr=lr)
    res = jax.device_put(jax.tree_util.tree_map(
        lambda x: jnp.zeros((2,) + x.shape, jnp.bfloat16), params),
        NamedSharding(mesh, P("pod")))
    losses = []
    with logical_axis_rules(mesh, rules):
        p, r = params, res
        for i in range(2):
            p, r, loss = jax.jit(step)(p, r, batch, jax.random.key(i))
            losses.append(float(loss))
    out[name] = {"losses": losses,
                 "p": jax.tree_util.tree_map(np.asarray, p),
                 "r": jax.tree_util.tree_map(
                     lambda x: np.asarray(x.astype(jnp.float32)), r)}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


class ReferenceRun:
    """The reference's v1 and v2 steps, 2 each, on a 4-device Auto mesh, in
    a subprocess started at once; :meth:`result` waits for it (the module's
    other tests run meanwhile)."""

    def __init__(self, shape, tmp_path):
        self.out = tmp_path / "ref.pkl"
        arg = json.dumps([list(shape), str(self.out), THGS, MASK_RATIO, LR,
                          B, T])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, arg], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env={**ENV, "JAX_PLATFORMS": "cpu"})
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            try:
                _, err = self.proc.communicate(timeout=600)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
            assert self.proc.returncode == 0, err[-3000:]
            with open(self.out, "rb") as f:
                self._result = pickle.load(f)
        return self._result

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _pair(**over):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("yi_6b"), **over),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get("yi_6b"), **over),
                               dtype="float32")
    return jcfg, tcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def check_free_running(ref: dict, shape, version: str,
                       groups=None) -> None:
    """The port's step from the reference's init and batch, 2 steps,
    against the reference's real step; with ``groups`` (one participant's
    groups, every participant's) the parameters are sharded over them
    (``launch.fsdp.shard_reference``) and the residual rows chunked."""
    jcfg, tcfg = _pair()
    p0 = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.key(0)))
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    mk = (ttrain.make_fl_train_step if version == "v1"
          else ttrain.make_fl_train_step_v2)
    if groups is None:
        model = convert.lm_params_from_jax(p0, tcfg)
        step = mk(tcfg, mesh, "pod", TTHGS(**THGS),
                  TSA(mask_ratio=MASK_RATIO), lr=LR)
        res = ttrain.init_fl_residuals(model, 2)
    else:
        model = fsdp.shard_reference(p0, tcfg, mesh, "pod", groups=groups)
        step = mk(tcfg, mesh, "pod", TTHGS(**THGS),
                  TSA(mask_ratio=MASK_RATIO), lr=LR, groups=[groups] * 2)
        res = ttrain.init_fl_residuals(model, 2, mesh, "pod",
                                       groups=[groups] * 2)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    losses = [float(step(model, res, batch, threefry.key(i))[2])
              for i in range(2)]
    want = ref[version]
    np.testing.assert_allclose(losses, want["losses"], rtol=0, atol=LOSS_TOL)
    got_p = _flat(convert.lm_tree_to_numpy(model, tcfg))
    want_p, want_r, start = _flat(want["p"]), _flat(want["r"]), _flat(p0)
    res = ttrain.stacked_residuals(res)
    leaves = convert.reference_leaves(model if groups is None
                                      else model.meta)
    for lid, leaf in enumerate(leaves):
        gp, wp = got_p[leaf.path], want_p[leaf.path]
        np.testing.assert_allclose(gp, wp, rtol=0, atol=PARAM_TOL,
                                   err_msg=leaf.path)
        assert (np.abs(gp - wp) > 1e-5).mean() <= MOVED_SHARE, leaf.path
        gr = res[lid].float().numpy()
        np.testing.assert_allclose(gr, want_r[leaf.path], rtol=0,
                                   atol=2 * PARAM_TOL, err_msg=leaf.path)
        assert (gp != start[leaf.path]).any(), leaf.path


@pytest.fixture(scope="module", autouse=True)
def ref_221(tmp_path_factory):
    job = ReferenceRun((2, 2, 1), tmp_path_factory.mktemp("ref221"))
    yield job
    job.close()


# ------------------------------------------------ the exchange, bit for bit
def _fake_mesh(shape):
    """What the reference's layout helpers read of a mesh."""
    return types.SimpleNamespace(axis_names=AXES, devices=np.empty(shape))


def _exchange_fn(n_fed, kb, nb, km, tr, size):
    """One jitted program: every participant's ``encode_leaf_blocked`` of
    a (sub-)leaf (``vmap``'d over ``self_id``, as the step's shard_map runs
    it with a traced axis index), then
    ``decode_blocked_sum`` of their streams with weight ``1 / n_fed``."""
    def fn(gs, rs, key):
        st, rn = jax.vmap(lambda g, r, me: jblocked.encode_leaf_blocked(
            g, r.astype(jnp.bfloat16), kb, nb, mask_key=key,
            k_mask_block=km, n_peers=n_fed, self_id=me, transform=tr))(
                gs, rs, jnp.arange(n_fed, dtype=jnp.int32))
        dense = jblocked.decode_blocked_sum(st.indices, st.values, size, nb,
                                            weight=1.0 / n_fed, transform=tr)
        return st.indices, st.values, rn.astype(jnp.float32), dense
    return jax.jit(fn)


def _layout(p_tree, shape):
    """The reference's leaves, specs and per-leaf k of a mesh shape."""
    mesh = _fake_mesh(shape)
    rules = jmesh.logical_rules(mesh, fed_axis="pod")
    pshapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), p_tree)
    p_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(p_tree)]
    specs = jax.tree_util.tree_leaves(
        jshd.param_specs(pshapes, rules, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return pshapes, p_leaves, specs


def oracle_v1(p_tree, grads, res, key, shape, thgs, sa, lr, aligned):
    """The reference v1 step's encode, exchange and update of one step
    (``repro/launch/train.py:264-490``) from per-participant gradient
    leaves: the encode and the decode jitted, the glue (``-lr * g`` in f32,
    the slicing, the f32 update) in numpy; ``aligned`` is
    ``REPRO_FL_ALIGNED_BLOCKS=1``. ``res``: numpy f32 leaves holding bf16
    values ``[n_fed, *leaf]``."""
    n_fed = shape[0]
    n_blocks = int(np.prod(shape)) // n_fed
    pshapes, p_leaves, specs = _layout(p_tree, shape)
    plan = jtrain.fl_leaf_plan(pshapes, thgs, n_blocks)
    leaf_k = jsched.leaf_ks(thgs, [x.size for x in p_leaves])
    axis_sizes = dict(zip(AXES, shape))
    streams, new_res, new_p = {}, [], []
    for lid, (pl, spec, (kb, nb)) in enumerate(zip(p_leaves, specs, plan)):
        tr = (jblocked.sharding_aligned_transform(pl.shape, spec, axis_sizes,
                                                  AXES[1:])
              if aligned else None)
        if tr is not None:
            nb = tr[2]
            kb = max(1, -(-leaf_k[lid] // nb))
        km = max(1, int(pl.size * sa.mask_ratio / n_fed / nb))
        gs = np.stack([np.float32(-lr) * np.asarray(g[lid]) for g in grads])
        rs = res[lid]
        entries = tuple(spec) + (None,) * pl.ndim
        lead, slice_shape = 0, None
        if pl.ndim >= 3:
            lead, n = 1, 0
            for di, d in enumerate(pl.shape[:-2]):
                if entries[di] is not None:
                    break
                lead *= d
                n += 1
            slice_shape = pl.shape[n:]
        if tr is None and lead > 1 and pl.size // lead >= 1 << 20:
            kb_s = max(1, -(-leaf_k[lid] // (nb * lead)))
            km_s = max(1, km // lead)
            fn = _exchange_fn(n_fed, kb_s, nb, km_s, None,
                              int(np.prod(slice_shape)))
            g_sl = gs.reshape(n_fed, lead, *slice_shape)
            r_sl = rs.reshape(n_fed, lead, *slice_shape)
            aggs, rn = [], []
            for i in range(lead):
                mk = jax.random.fold_in(jax.random.fold_in(key, lid), i)
                idx, vals, r2, dense = fn(g_sl[:, i], r_sl[:, i], mk)
                streams[(lid, i)] = (np.asarray(idx), np.asarray(vals))
                rn.append(np.asarray(r2))
                aggs.append(np.asarray(dense).reshape(slice_shape))
            agg = np.stack(aggs).reshape(pl.shape)
            new_res.append(np.stack(rn, 1).reshape((n_fed,) + pl.shape))
        else:
            fn = _exchange_fn(n_fed, kb, nb, km, tr, pl.size)
            idx, vals, r2, dense = fn(gs, rs, jax.random.fold_in(key, lid))
            streams[(lid, None)] = (np.asarray(idx), np.asarray(vals))
            new_res.append(np.asarray(r2))
            agg = np.asarray(dense).reshape(pl.shape)
        new_p.append(pl + agg)
    return streams, new_res, new_p


def oracle_v2(p_tree, grads, res, key, shape, thgs, sa, lr, generic):
    """The reference v2 step's encode, exchange and update
    (``repro/launch/train.py:115-261``): ``encode_batch_blocks`` and the
    dense scatter jitted, the glue in numpy."""
    n_fed = shape[0]
    axis_sizes = dict(zip(AXES, shape))
    _, p_leaves, specs = _layout(p_tree, shape)
    leaf_k = jsched.leaf_ks(thgs, [x.size for x in p_leaves])
    streams, new_res, new_p = {}, [], []
    for lid, (pl, gspec) in enumerate(zip(p_leaves, specs)):
        tr = (None if generic else jblocked.sharding_aligned_transform(
            pl.shape, gspec, axis_sizes, AXES[1:]))
        if tr is not None:
            to_b, from_b, nb, m, _ = tr
        else:
            nb, m, padded = jblocked.block_layout(pl.size,
                                                  shape[1] * shape[2])
            to_b = (lambda x, _p=padded, _nb=nb, _m=m, _s=pl.size:
                    np.pad(x.reshape(-1), (0, _p - _s)).reshape(_nb, _m))
            from_b = (lambda b2, _s=pl.size, _sh=pl.shape:
                      b2.reshape(-1)[:_s].reshape(_sh))
        kb = max(1, min(m, -(-leaf_k[lid] // nb)))
        gs = [np.asarray(g[lid]).astype(jnp.bfloat16).astype(np.float32)
              for g in grads]
        acc = np.stack([to_b(res[lid][p]) + to_b(np.float32(-lr) * gs[p])
                        for p in range(n_fed)])
        km = max(1, int(pl.size * sa.mask_ratio / n_fed / nb))
        keys, signs = jstreams.fold_pair_key_matrix(
            jax.random.fold_in(key, lid), n_fed)

        def fn(a, k, s, _kb=kb, _km=km, _nb=nb, _m=m):
            st, new_blocks = jstreams.encode_batch_blocks(
                a, _kb, pair_keys=k, pair_signs=s, k_mask=_km,
                mask_p=sa.p, mask_q=sa.q)
            dense = jnp.zeros((_nb, _m), jnp.float32).at[
                st.indices // _m, st.indices % _m].add(st.values / n_fed)
            return st.indices, st.values, new_blocks, dense

        idx, vals, new_blocks, dense = jax.jit(fn)(acc, keys, signs)
        streams[(lid, None)] = (np.asarray(idx), np.asarray(vals))
        nbk = np.asarray(new_blocks)
        new_res.append(np.stack([
            from_b(nbk[p]).astype(jnp.bfloat16).astype(np.float32)
            for p in range(n_fed)]))
        new_p.append(pl + from_b(np.asarray(dense)))
    return streams, new_res, new_p


def _bits_equal(a, b) -> bool:
    a = np.ascontiguousarray(np.asarray(a))
    b = b.detach().cpu()
    b = np.ascontiguousarray(
        (b.float() if b.dtype == torch.bfloat16 else b).numpy())
    if a.dtype == jnp.bfloat16:
        a = a.astype(np.float32)
    return a.shape == b.shape and a.dtype == b.dtype and \
        (a.view(np.uint8) == b.view(np.uint8)).all()


_GRADS: dict = {}


def _reference_gradients(over: dict, n_fed: int):
    """The reference's init and each participant's gradients on its rows
    of a seeded batch (cached per config)."""
    key = (tuple(sorted(over.items())), n_fed)
    if key not in _GRADS:
        jcfg, _ = _pair(**over)
        p0 = jtf.init_params(jcfg, jax.random.key(0))
        rs = np.random.RandomState(3)
        batch = {"tokens": rs.randint(0, jcfg.vocab, (B, T)).astype(np.int32),
                 "labels": rs.randint(0, jcfg.vocab, (B, T)).astype(np.int32)}
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: jtrain.loss_fn(p, jcfg, b)))
        rows = B // n_fed
        _GRADS[key] = p0, [vg(p0, {k: v[i * rows:(i + 1) * rows]
                                   for k, v in batch.items()})[1]
                           for i in range(n_fed)]
    return _GRADS[key]


def check_exchange(version, shape, env, over, monkeypatch) -> None:
    """The port's exchange stage against the reference-built oracle, given
    the reference's gradients and seeded non-zero residuals."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, tcfg = _pair(**over)
    n_fed = shape[0]
    p0, grad_trees = _reference_gradients(over, n_fed)
    p_leaves = jax.tree_util.tree_leaves(p0)
    rs = np.random.RandomState(4)
    res_np = [(0.01 * rs.randn(n_fed, *x.shape)).astype(np.float32)
              for x in p_leaves]
    key = jax.random.fold_in(jax.random.key(9), 4)
    thgs, sa = JTHGS(**THGS), JSA(mask_ratio=MASK_RATIO)
    grads = [jax.tree_util.tree_leaves(g) for g in grad_trees]
    jres = [r.astype(jnp.bfloat16).astype(np.float32) for r in res_np]
    if version == "v1":
        w_streams, w_res, w_p = oracle_v1(p0, grads, jres, key, shape,
                                          thgs, sa, LR, aligned=bool(env))
    else:
        w_streams, w_res, w_p = oracle_v2(
            p0, grads, jres, key, shape, thgs, sa, LR,
            generic=bool(env))

    model = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, p0), tcfg)
    t_grads = [{n: t.detach() for n, t in convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, g), tcfg).named_parameters()}
        for g in grad_trees]
    t_res = [torch.from_numpy(r).to(torch.bfloat16) for r in res_np]
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    mk = (ttrain.make_fl_train_step if version == "v1"
          else ttrain.make_fl_train_step_v2)
    step = mk(tcfg, mesh, "pod", TTHGS(**THGS), TSA(mask_ratio=MASK_RATIO),
              lr=LR)
    rec = []
    step.exchange(model, t_res, t_grads,
                  threefry.fold_in(threefry.key(9), 4), record=rec)
    got = [(r["leaf"], r["slice"], r["streams"]) for r in rec]
    assert all(float(r["agg_absmax"]) > 0 for r in rec)
    if version == "v1":
        assert any(sl is not None for _, sl, _ in got) == bool(over)
        assert len(got) == len(w_streams)
        for lid, sl, sts in got:
            w_idx, w_vals = w_streams[(lid, sl)]
            assert _bits_equal(w_idx, torch.stack([x.indices for x in sts]))
            assert _bits_equal(w_vals, torch.stack([x.values for x in sts]))
    else:
        assert len(got) == len(w_streams)
        for lid, _, st in got:
            w_idx, w_vals = w_streams[(lid, None)]
            assert _bits_equal(w_idx, st.indices), lid
            assert _bits_equal(w_vals, st.values), lid
    leaves = convert.reference_leaves(model)
    got_p = _flat(convert.lm_tree_to_numpy(model, tcfg))
    for lid, leaf in enumerate(leaves):
        assert _bits_equal(w_res[lid], t_res[lid]), leaf.path
        assert _bits_equal(w_p[lid], torch.from_numpy(got_p[leaf.path])), \
            leaf.path


@pytest.mark.parametrize("version,shape,env", [
    ("v1", (2, 2, 1), {}),
    ("v1", (2, 2, 1), {"REPRO_FL_ALIGNED_BLOCKS": "1"}),
    ("v2", (2, 2, 1), {}),
], ids=["v1-221", "v1-221-aligned", "v2-221"])
def test_exchange_with_reference_gradients_is_bit_equal_to_oracle(
        version, shape, env, monkeypatch):
    check_exchange(version, shape, env, {}, monkeypatch)


# ---------------------------------------------------------------- the CLI
def _cli(*args, cwd):
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.fl_train",
                        "--device", "cpu", "--log-every", "1", *args],
                       capture_output=True, text=True, env=ENV, cwd=cwd,
                       timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _losses(out: str) -> list:
    return [float(line.split("loss=")[1]) for line in out.splitlines()
            if "loss=" in line]


def test_cli_trains_resumes_bit_equal_and_writes_the_reference_ledger(
        tmp_path):
    full = _cli("--steps", "6", "--ckpt", str(tmp_path / "a"), cwd=tmp_path)
    losses = _losses(full)
    assert len(losses) == 6 and losses[-1] < losses[0], full
    assert "checkpoint written to" in full and "(tpu accounting)" in full
    first = _cli("--steps", "3", "--ckpt", str(tmp_path / "b"), cwd=tmp_path)
    resumed = _cli("--steps", "6", "--ckpt", str(tmp_path / "b"),
                   cwd=tmp_path)
    assert "resumed from" in resumed and "at step 3" in resumed
    assert _losses(first) + _losses(resumed) == losses
    with np.load(tmp_path / "a" / "step_00000006.npz") as a, \
            np.load(tmp_path / "b" / "step_00000006.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("['residuals']") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # the checkpoint's leaves are the reference example's: its params tree
    # and bf16 residuals [2, *leaf], keyed by the reference's tree paths
    from repro.checkpoint import store as jstore

    jcfg = jconfigs.reduced(jconfigs.get("xlstm-125m"))
    pshapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                     jax.random.key(0)))
    ref_keys = jstore._flatten({"params": pshapes, "residuals": pshapes})
    with np.load(tmp_path / "a" / "step_00000006.npz") as a:
        assert sorted(a.files) == sorted(ref_keys)
        for k, leaf in ref_keys.items():
            lead = (2,) if k.startswith("['residuals']") else ()
            assert a[k].shape == lead + tuple(leaf.shape), k

    # the ledger against the reference example's step_wire_record
    spec = importlib.util.spec_from_file_location(
        "federated_llm_training", ROOT / "examples" /
        "federated_llm_training.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rec = example.step_wire_record(0, pshapes, JTHGS(s0=0.05, alpha=0.9,
                                                     s_min=0.01),
                                   JSA(mask_ratio=0.01), 2, 4)
    from repro.sim import CommLedger as JLedger

    want = JLedger()
    for i in range(6):
        want.record(dataclasses.replace(rec, round=i))
    with open(tmp_path / "a" / "comm_ledger.json") as f:
        got = json.load(f)
    assert got["ledger"] == json.loads(json.dumps(want.summary()))
    assert got["arch"] == "xlstm-125m" and got["steps"] == 6


def test_fl_modules_load_no_jax():
    code = ("import sys, repro_torch, repro_torch.core.threefry, "
            "repro_torch.core.blocked, repro_torch.launch.train, "
            "repro_torch.launch.fl_train, repro_torch.launch.specs, "
            "repro_torch.launch.shardings, repro_torch.models.sharding; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=ENV)
    assert p.returncode == 0, p.stdout + p.stderr


# ------------------------------------- the free-running step (waits last)
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_free_running_step_matches_reference_221(ref_221, version):
    check_free_running(ref_221.result(), (2, 2, 1), version)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_sharded_step_matches_reference_221(ref_221, version):
    """Each participant over two groups on the CPU (its data positions 0
    and 1): gradients as f32 sums of two halves, parameters and residual
    rows in chunks; the reference's tolerances hold."""
    cpu = torch.device("cpu")
    check_free_running(ref_221.result(), (2, 2, 1), version,
                       groups=[(cpu, range(0, 1)), (cpu, range(1, 2))])
