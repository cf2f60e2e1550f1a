"""Port: the expert-parallel MoE layer of ``launch/tp.py`` (``moe_routed``,
``moe_block``) against ``models/moe.apply_moe`` and the JAX reference.

A data group's model positions share the CPU through an explicit grid
(``((cpu,) * m, range(0, 1))``), as in ``tests/test_torch_tp.py``. Every
input and every MoE weight comes from a numpy seed (each routed expert its
own draw, so a token sent to the wrong expert shows).

* **The layer** on the same whole input as ``apply_moe``, reduced
  DeepSeek-MoE-16B (top-2, a shared expert) and Llama-4-Scout (top-1), f32,
  at model 2 (two experts a position), 3 (4 experts do not split: each
  position takes its span of the whole) and 4 (one expert a position: a
  batch of ONE in the experts' ``bmm``, bit-equal on the CPU), on a split
  stream and a whole one. The routed output and the aux loss are bit-equal
  to ``apply_moe``'s (without the shared expert), and so is every routed
  expert leaf's gradient. The whole layer's output is within
  ``SHARED_Y_TOL`` of ``apply_moe``'s: the shared expert's row-parallel
  ``wo`` adds its positions' partial sums in f32 in position order, where
  one product summed its hidden columns in one pass (the dense MLP's rule,
  ``tests/test_torch_tp.py``). The shared expert's leaves' gradients are
  bit-equal where ``m`` divides its hidden width, and within
  ``SHARED_GRAD_REL`` of their max |g| where the spans are uneven (the
  CPU's matrix product blocks a 42- or 43-column slice otherwise). The
  router's gradient is bit-equal: position 0 routes once, and the gates'
  gradients come back to it from their owners alone.
* **One routing.** A position's own router copy that would route a
  near-tie otherwise changes nothing: every position dispatches by
  position 0's ids and gates.
* **Reads.** A position reads only its own ``model`` chunk of the routed
  and shared expert leaves (a spy on ``GridView``), never a gathered one.
* **The reference.** The dense step of reduced DeepSeek-MoE-16B against
  the reference's real step on the Auto-axis meshes (1, 2) and (1, 4) of
  4 fake CPU devices (a subprocess started with the module), with the
  tolerances of ``tests/test_torch_tp.py``.
* **Placement.** Positions on ``[cpu, cpu:0]`` and on ``[cpu, cpu]`` give
  the same bits.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import fsdp, tp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
       "JAX_PLATFORMS": "cpu"}
AXES = ("data", "model")
CPU = torch.device("cpu")
ARCHS = ["deepseek_moe_16b", "llama4_scout_17b_a16e"]
EXPERTS = ("wi_gate", "wi_up", "wo")
SHARED = ("shared_wi_gate", "shared_wi_up", "shared_wo")
PREFIX = "blocks.0.moe."
# about 2x the readings over the cases below (f32): the layer's output
# 1.431e-06 apart (3.1e-7 of its max |y|); the shared leaves' gradients
# 3.73e-08 of their max |g| at model 3
SHARED_Y_TOL = 3e-6
SHARED_GRAD_REL = 8e-8
# the reference's tolerances (tests/test_torch_tp.py)
LOSS_TOL, GRAD_REL, PARAM_TOL = 2e-5, 1e-4, 1e-6
LR = 0.01
B, T = 4, 32
# (m, T): split where m divides T, else whole on every position
LAYER_CASES = [(2, 32), (2, 31), (3, 30), (3, 32), (4, 32), (4, 30)]


def grid(m: int, devices=None) -> list:
    return [(tuple(devices or (CPU,) * m), range(0, 1))]


def _cfg(arch: str):
    return dataclasses.replace(configs.reduced(configs.get(arch)),
                               dtype="float32")


def _model(cfg, seed: int = 0):
    """The port's init with every MoE leaf redrawn from a numpy seed."""
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    rs = np.random.RandomState(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".moe." in name:
                d_in, d_out = p.shape[-2:]
                draw = rs.randn(*p.shape) * (2.0 / (d_in + d_out)) ** 0.5
                p.copy_(torch.from_numpy(draw.astype(np.float32)))
    return model


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().reshape(-1).numpy().view(np.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((_bits(a) == _bits(b)).all())


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _lm(cfg, m: int, model=None, devices=None):
    return fsdp.shard(_model(cfg) if model is None else model,
                      tmesh.LogicalMesh((1, m), AXES, "cpu"),
                      groups=grid(m, devices))


def _reference(model, x, cot, spec, shared: bool):
    """``apply_moe`` on block 0's leaves (the shared expert's left out
    unless ``shared``): (y, aux, {leaf: gradient of <y, cot> + aux})."""
    p = {n[len(PREFIX):]: t.detach().clone().requires_grad_(True)
         for n, t in model.named_parameters() if n.startswith(PREFIX)}
    if not shared:
        p = {n: t for n, t in p.items() if not n.startswith("shared_")}
    out = moe_mod.apply_moe(p, x, spec)
    grads = torch.autograd.grad((out.y * cot).sum() + out.aux_loss,
                                list(p.values()))
    return out.y.detach(), out.aux_loss.detach(), dict(zip(p, grads))


def _grid_layer(lm, cfg, x, cot, fn):
    """``fn`` (``tp.moe_routed`` or ``tp.moe_block``) over the grid on the
    whole rows ``x`` on every position: (the whole output, aux, {leaf: its
    gradient, each chunk's partials folded in position order}). A whole
    stream's cotangent goes to position 0's copy."""
    view = tp.GridView(lm, 0)
    st = tp.Stream(view.devices, x.shape[1])
    hs = [x.clone().to(d) for d in view.devices]
    with torch.enable_grad():
        ys, aux = fn(view, PREFIX, cfg, st, hs)
        if st.split:
            y = torch.cat([t.to(CPU) for t in ys], 1)
            loss = sum((t * c.to(t.device)).sum() for t, c in zip(
                ys, cot.chunk(view.m, 1)))
        else:
            assert all(_same(t, ys[0]) for t in ys)
            y, loss = ys[0], (ys[0] * cot).sum()
        reads = [r for r in view.reads if r[1][0].startswith(PREFIX)]
        grads = torch.autograd.grad(loss + aux, [a for _, _, a in reads],
                                    allow_unused=True)
    parts: dict = {}
    for (j, key, _), g in sorted(zip(reads, grads), key=lambda r: r[0][0]):
        if g is not None:
            parts.setdefault(key, []).append(g)
    out: dict = {}
    for name in sorted({k[0] for k in parts}):
        keys = sorted((k for k in parts if k[0] == name),
                      key=lambda k: -1 if k[2] is None else k[2])
        chunks = [tp.fold(parts[k], CPU) for k in keys]
        md = lm.mdims[name]
        out[name[len(PREFIX):]] = (chunks[0] if md is None
                                   else torch.cat(chunks, md))
    return y.detach(), aux.detach(), out, st.split


def _inputs(cfg, t: int, seed: int = 7):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(B, t, cfg.d_model).astype(np.float32))
    cot = torch.from_numpy(rs.randn(B, t, cfg.d_model).astype(np.float32))
    return x, cot


# ------------------------------------------------------------- the layer
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("m,t", LAYER_CASES,
                         ids=[f"m{m}-T{t}" for m, t in LAYER_CASES])
def test_routed_output_aux_and_expert_gradients_are_bit_equal(arch, m, t):
    cfg = _cfg(arch)
    model = _model(cfg)
    lm = _lm(cfg, m, model)
    split_e = lm.mdims[PREFIX + "wo"] is not None
    assert split_e == (cfg.moe.n_experts % m == 0)
    x, cot = _inputs(cfg, t)
    y_want, aux_want, g_want = _reference(model, x, cot, cfg.moe, False)
    y, aux, grads, split = _grid_layer(lm, cfg, x, cot, tp.moe_routed)
    assert split == (t % m == 0)
    assert _same(y, y_want) and _same(aux, aux_want)
    for name in EXPERTS:
        assert _same(grads[name], g_want[name]), name
        assert grads[name].abs().amax((1, 2)).gt(0).all(), name
    assert _same(grads["router"], g_want["router"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("m,t", LAYER_CASES,
                         ids=[f"m{m}-T{t}" for m, t in LAYER_CASES])
def test_whole_layer_against_apply_moe(arch, m, t):
    cfg = _cfg(arch)
    model = _model(cfg)
    x, cot = _inputs(cfg, t, seed=8)
    y_want, aux_want, g_want = _reference(model, x, cot, cfg.moe, True)
    y, aux, grads, _ = _grid_layer(_lm(cfg, m, model), cfg, x, cot,
                                   tp.moe_block)
    assert _same(aux, aux_want)
    assert float((y - y_want).abs().max()) <= SHARED_Y_TOL
    for name in EXPERTS:
        assert _same(grads[name], g_want[name]), name
    fs = cfg.moe.n_shared * cfg.moe.d_ff_expert
    for name in SHARED:
        if fs % m == 0:
            assert _same(grads[name], g_want[name]), name
        else:
            assert _rel(grads[name], g_want[name]) <= SHARED_GRAD_REL, name
    assert _same(grads["router"], g_want["router"])


def test_capacity_drops_come_from_the_whole_row():
    """Every token routed to expert 0 (a router that prefers it): most of
    its assignments overflow the capacity, and the positions drop exactly
    the assignments ``apply_moe`` drops."""
    cfg = _cfg("deepseek_moe_16b")
    model = _model(cfg)
    with torch.no_grad():
        model.get_parameter(PREFIX + "router")[:, 0] += 5.0
    x, cot = _inputs(cfg, T)
    x = x.abs()                       # x @ router favours expert 0
    probs, _, eidx = moe_mod.router(
        {"router": model.get_parameter(PREFIX + "router")}, x, cfg.moe)
    assert int((eidx == 0).sum(1).max()) > moe_mod.capacity(T, cfg.moe)
    y_want, aux_want, g_want = _reference(model, x, cot, cfg.moe, False)
    for m in (2, 4):
        y, aux, grads, _ = _grid_layer(_lm(cfg, m, model), cfg, x, cot,
                                       tp.moe_routed)
        assert _same(y, y_want) and _same(aux, aux_want)
        assert all(_same(grads[n], g_want[n]) for n in EXPERTS)


def test_one_routing_for_every_position_at_a_near_tie():
    """Position 1's own router copy (another device object, so another
    tensor) is nudged so that it would route the token nearest a top-k tie
    to another expert, as a copy on another device type might by its low
    bits. The layer still equals ``apply_moe`` on position 0's router:
    every position dispatches by position 0's ids and gates."""
    cfg = _cfg("deepseek_moe_16b")
    k = cfg.moe.top_k
    model = _model(cfg)
    lm = _lm(cfg, 2, model, devices=[CPU, torch.device("cpu", 0)])
    r0 = lm.chunks[lm.cell(0, 0)][PREFIX + "router"]
    r1 = lm.chunks[lm.cell(0, 1)][PREFIX + "router"]
    assert r0 is not r1 and _same(r0, r1)
    x, cot = _inputs(cfg, T)
    logits = x @ r0
    top = logits.topk(k + 1, -1)
    gap = top.values[..., k - 1] - top.values[..., k]          # [B, T]
    b, t = divmod(int(gap.argmin()), T)
    xt = x[b, t]
    with torch.no_grad():
        r1[:, top.indices[b, t, k]] += xt * (2 * gap[b, t] / xt.dot(xt))
    _, _, e0 = moe_mod.router({"router": r0}, x, cfg.moe)
    _, _, e1 = moe_mod.router({"router": r1}, x, cfg.moe)
    assert not torch.equal(e0[b, t], e1[b, t])
    y_want, aux_want, g_want = _reference(model, x, cot, cfg.moe, False)
    y, aux, grads, _ = _grid_layer(lm, cfg, x, cot, tp.moe_routed)
    assert _same(y, y_want) and _same(aux, aux_want)
    for name in EXPERTS + ("router",):
        assert _same(grads[name], g_want[name]), name


def test_a_span_dispatch_is_the_whole_dispatch_cut():
    """``_dispatch`` over an expert span fills exactly those experts'
    slots of the whole dispatch, and marks every other assignment as not
    held; the whole span is the whole dispatch."""
    spec = _cfg("deepseek_moe_16b").moe
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 24, 8).astype(np.float32))
    eidx = torch.from_numpy(np.stack([np.stack([rs.permutation(4)[:2]
                                                for _ in range(24)])
                                      for _ in range(2)]))
    cap = 8                                 # some assignments overflow
    buf, slot, order = moe_mod._dispatch(x, eidx, 4, 2, cap)
    for lo, hi in ((0, 4), (0, 2), (2, 4), (1, 2), (3, 3)):
        b2, s2, o2 = moe_mod._dispatch(x, eidx, 4, 2, cap, (lo, hi))
        assert _same(o2, order) and _same(b2, buf[:, lo:hi])
        held = (slot >= lo * cap) & (slot < hi * cap)
        assert torch.equal(s2[held], slot[held] - lo * cap)
        assert bool((s2[~held] == (hi - lo) * cap).all())


# ------------------------------------------------------------- the reads
@pytest.mark.parametrize("m", [2, 4])
def test_positions_read_only_their_own_expert_chunks(m, monkeypatch):
    cfg = _cfg("deepseek_moe_16b")
    lm = _lm(cfg, m)
    names = [n for n in lm.shapes if n.rsplit(".", 1)[-1] in EXPERTS + SHARED
             and ".moe." in n]
    assert names and all(lm.mdims[n] is not None for n in names)
    chunks, wholes = [], []
    real_chunk, real_whole = tp.GridView.chunk, tp.GridView.whole

    def chunk(self, j, name, i):
        if name in names:
            chunks.append((j, name, i))
        return real_chunk(self, j, name, i)

    def whole(self, j, name):
        if name in names:
            wholes.append((j, name))
        return real_whole(self, j, name)

    monkeypatch.setattr(tp.GridView, "chunk", chunk)
    monkeypatch.setattr(tp.GridView, "whole", whole)
    rs = np.random.RandomState(1)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, (2, T))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    fsdp.step_gradients(lm, cfg, batch)
    assert not wholes
    # every leaf read, by every position, and each only its own chunk
    assert {(j, n) for j, n, _ in chunks} == {(j, n) for j in range(m)
                                              for n in names}
    assert all(j == i for j, _, i in chunks)


def test_no_moe_weight_is_saved_outside_the_remats():
    cfg = _cfg("deepseek_moe_16b")
    lm = _lm(cfg, 2)
    moe = {tuple(lm.chunks[0][n].shape) for n in lm.shapes if ".moe." in n}
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    rs = np.random.RandomState(1)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, (2, T))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        loss = tp.train_loss(tp.GridView(lm, 0), cfg, batch)
    assert loss.requires_grad and saved and moe
    assert not moe & set(saved), sorted(moe & set(saved))


# ---------------------------------------------------------- the reference
REF_MOE = r"""
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
from repro.launch.train import make_dense_train_step
shapes, out_path, lr, B, T = json.loads(sys.argv[1])
cfg = dataclasses.replace(configs.reduced(configs.get("deepseek_moe_16b")),
                          dtype="float32")
params0 = tf.init_params(cfg, jax.random.key(0))
# every expert its own draw (the reference broadcasts one matrix to all)
rs = np.random.RandomState(11)
moe = dict(params0["blocks"]["moe"])
for name in ("wi_gate", "wi_up", "wo"):
    d_in, d_out = moe[name].shape[-2:]
    draw = rs.randn(*moe[name].shape) * (2.0 / (d_in + d_out)) ** 0.5
    moe[name] = jnp.asarray(draw.astype(np.float32))
params0 = dict(params0, blocks=dict(params0["blocks"], moe=moe))
rs = np.random.RandomState(5)
batch_np = {"tokens": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32),
            "labels": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)}
out = {"batch": batch_np,
       "p0": jax.tree_util.tree_map(np.asarray, params0)}
for shape in shapes:
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    rules = logical_rules(mesh)
    pshapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params0)
    params = jax.device_put(params0, shd.named(
        shd.param_specs(pshapes, rules, mesh), mesh))
    batch = jax.device_put({k: jnp.asarray(v) for k, v in batch_np.items()},
                           NamedSharding(mesh, P("data", None)))
    with logical_axis_rules(mesh, rules):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: tf.train_loss(p, cfg, b)))(params, batch)
        p, step_loss = jax.jit(make_dense_train_step(cfg, lr))(params, batch)
    out[str(tuple(shape))] = {
        "loss": float(loss), "step_loss": float(step_loss),
        "grads": jax.tree_util.tree_map(np.asarray, grads),
        "p": jax.tree_util.tree_map(np.asarray, p)}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""
REF_SHAPES = [(1, 2), (1, 4)]


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    """The reference's dense step of reduced DeepSeek-MoE-16B on each of
    ``REF_SHAPES``, in a subprocess started with the module."""
    out = tmp_path_factory.mktemp("moe_ref") / "moe.pkl"
    arg = json.dumps([[list(s) for s in REF_SHAPES], str(out), LR, B, T])
    proc = subprocess.Popen([sys.executable, "-c", REF_MOE, arg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, env=ENV)
    result: dict = {}

    def get() -> dict:
        if not result:
            try:
                _, err = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
            assert proc.returncode == 0, err[-3000:]
            with open(out, "rb") as f:
                result.update(pickle.load(f))
        return result

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("shape", REF_SHAPES, ids=str)
def test_dense_step_matches_the_reference_mesh(shape, moe_ref):
    ref = moe_ref()
    want = ref[str(shape)]
    cfg = _cfg("deepseek_moe_16b")
    m = shape[1]
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    lm = fsdp.shard_reference(ref["p0"], cfg, mesh, groups=grid(m))
    assert lm.mdims["blocks.0.moe.wo"] == 0      # E 4 splits over model
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, grads = fsdp.step_gradients(lm, cfg, batch)
    assert abs(float(loss) - want["loss"]) <= LOSS_TOL
    got_g = _flat(convert.lm_tree_to_numpy(
        {n: grads.full(n, CPU) for n in lm.shapes}, cfg))
    for path, w in _flat(want["grads"]).items():
        gap = np.abs(got_g[path] - w).max() / max(np.abs(w).max(), 1e-30)
        assert gap <= GRAD_REL, (path, gap)
    # every routed expert reached (each its own draw)
    assert np.all(np.abs(got_g["blocks.moe.wo"]).max(axis=(2, 3)) > 0)
    _, step_loss = ttrain.make_dense_train_step(cfg, LR, mesh=None)(lm,
                                                                   batch)
    assert abs(float(step_loss) - want["step_loss"]) <= LOSS_TOL
    got_p = _flat(convert.lm_tree_to_numpy(lm, cfg))
    for path, w in _flat(want["p"]).items():
        np.testing.assert_allclose(got_p[path], w, rtol=0, atol=PARAM_TOL,
                                   err_msg=path)


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_moves_no_bit(arch):
    """Positions on ``cpu`` and on ``cpu:0`` (another device object: the
    exchange moves tensors between them) compute the same bits."""
    cfg = _cfg(arch)
    rs = np.random.RandomState(2)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, (2, T))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    two = [CPU, torch.device("cpu", 0)]
    la, ga = fsdp.step_gradients(_lm(cfg, 2, devices=two), cfg, batch)
    lm = _lm(cfg, 2)
    lb, gb = fsdp.step_gradients(lm, cfg, batch)
    assert _same(la, lb)
    assert all(_same(ga.full(n, CPU), gb.full(n, CPU)) for n in lm.shapes)
