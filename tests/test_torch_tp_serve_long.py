"""Port: a batch of one row served over a participant's whole ``(data,
model)`` grid (``launch/tp_serve.py`` through ``launch/serve.py``'s
steps): the reference's ``long_500k`` rewrite (``specs.folds``; the idle
batch axes fold into the KV cache's sequence split, ``kv_seq = (data...,
model)``, ``batch`` on no axis), every data group serving the row, the
caches split over every cell in ``input_pspecs``' data-major order and the
cache statistics combined across every cell.

Without a card the grid's cells share the CPU through an explicit list
(``((cpu,) * m, range(g, g + 1))``), as in ``tests/test_torch_tp_serve.py``.
Reduced configurations in f32, each in its long-context variant
(``long_context_variant``) with the window cut to 16; one row, a prompt
of 518 tokens into a cache of 1,040 slots (260 a cell over 4 cells, 520
over 2), then 6 decode steps writing slots 518-523: the window reads cell
1 alone, then straddles cells 1 and 2, across the data-group boundary at
slot 520; cells 0 and 3 read nothing. The VLM has 1,024 image tokens, so
its cross K/V split too.

* **Against the one-device steps**: reduced Yi-6B, DeepSeek-MoE-16B,
  Llama-3.2-Vision-90B, Zamba2-7B and xLSTM-125M over (2, 1), (2, 2) and
  (4, 1): logits and every state leaf within 2e-5, every cell's
  recurrent copy bit-equal (data groups included).
* **Against the reference's real ``jax.jit`` steps** under the rewritten
  rules on Auto-axis meshes (2, 2) and (2, 1) of 4 fake CPU devices
  (parameters by ``param_specs``, the state by ``input_pspecs``; a
  subprocess started with the module): prefill logits and 6 decode steps
  (fed the reference's greedy tokens) within 2e-5.
* **Edges**: idle cells add exactly 0 while the window straddles the
  data-group boundary; writes at cell boundaries (slots 259 | 260 and 519
  | 520) on the cell that holds the slot alone; the greedy loop and the
  flash launches of a folded prefill; a batch of 3 over 2 groups raises.
* **Placement**: each cell's bytes equal ``input_pspecs``' under the
  rewritten rules (``dryrun.step_rules``), for the prefill's state,
  ``init_state`` and ``place_state``, and Yi-6B's ``long_500k`` state on a
  meta (16, 16) grid.
* **Bits unchanged**: the grid steps at data 1 and at batches above 1 are
  bit-equal to their code as it stood before the fold, kept verbatim
  below.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, fsdp, serve, specs, tp, tp_serve  # noqa: E402,E501
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.launch.tp_serve import (  # noqa: E402
    GridState, check_decode, columns, has_recurrent, image_slots,
    kv_by_exchange, leaves_by_kind, logits, own_heads, prefill_attention,
    rebuild, share, slots, split_over_model, ssm_decode, ssm_prefill,
    xlstm_decode, xlstm_prefill)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
AXES = ("data", "model")
CPU = torch.device("cpu")
TOL = 2e-5                 # f32 logits and state leaves, grid vs one device
T, S, N_DECODE, WINDOW = 518, 1040, 6, 16
SHAPES = [(2, 1), (2, 2), (4, 1)]
REF_SHAPES = [(2, 2), (2, 1)]
FAMILIES = {"yi_6b": {}, "deepseek_moe_16b": {},
            "llama32_vision_90b": {"n_image_tokens": 1024},
            "zamba2_7b": {}, "xlstm_125m": {}}
ARCHS = list(FAMILIES)


def grid(m: int, n_groups: int) -> list:
    return [((CPU,) * m, range(g, g + 1)) for g in range(n_groups)]


def _cfg(arch: str, **over):
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)).
                              long_context_variant(),
                              dtype="float32", **FAMILIES[arch], **over)
    if cfg.window is not None:
        cfg = dataclasses.replace(cfg, window=WINDOW)
    return cfg


def _model(cfg, seed: int = 0):
    return tf.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def _lm(model, shape) -> fsdp.ShardedLM:
    n_data, m = shape
    return fsdp.shard(model, tmesh.LogicalMesh(shape, AXES, "cpu"),
                      groups=grid(m, n_data))


def _inputs(cfg, rows: int, t: int, seed: int) -> tuple:
    rs = np.random.RandomState(seed)
    prompt = torch.from_numpy(rs.randint(0, cfg.vocab, (rows, t))
                              .astype(np.int32))
    img = (torch.from_numpy(rs.randn(rows, cfg.n_image_tokens, cfg.d_model)
                            .astype(np.float32))
           if cfg.family == "vlm" else None)
    return prompt, img


def _tokens(cfg, rows: int, seed: int) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, cfg.vocab, (rows, 1))
                            .astype(np.int32))


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((_bits(a) == _bits(b)).all())


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _serve_both(cfg, lm, model, seed: int = 1) -> tuple:
    """Prefill one row of ``T`` tokens and ``N_DECODE`` decode steps on the
    one device and on the grid, fed the same tokens: the largest logit
    gap, both states."""
    prompt, img = _inputs(cfg, 1, T, seed)
    l1, one = serve.make_prefill_step(cfg, S)(model, prompt, img)
    l2, state = serve.make_prefill_step(cfg, S)(lm, prompt, img)
    assert l2.shape == l1.shape == (1, 1, cfg.vocab)
    gaps = [_gap(l1, l2)]
    dec = serve.make_decode_step(cfg)
    for i in range(N_DECODE):
        tok = _tokens(cfg, 1, 10 + i)
        l1, one = dec(model, tok, one)
        l2, state = dec(lm, tok, state)
        gaps.append(_gap(l1, l2))
    return max(gaps), one, state


def _check_state(cfg, one: tf.DecodeState, state: tp_serve.GridState,
                 lm) -> None:
    """Every leaf of the folded grid state against the one-device state:
    each cache's (and cross K/V's) cells in cell order, the lengths equal
    on every cell, every cell's recurrent copy bit-equal to cell (0, 0)'s
    and within ``TOL`` of the one device's."""
    caches, cross, rec = tp_serve.leaves_by_kind(cfg, one)
    n = len(lm.groups)
    assert state.folded and len(state.caches) == n
    for i, c1 in enumerate(caches):
        cells = [c for g in range(n) for c in state.caches[g][i]]
        if state.split:
            assert _gap(torch.cat([c.k for c in cells], 1), c1.k) <= TOL
            assert _gap(torch.cat([c.v for c in cells], 1), c1.v) <= TOL
        else:
            for c in cells:
                assert _gap(c.k, c1.k) <= TOL and _gap(c.v, c1.v) <= TOL
        for c in cells:
            assert torch.equal(c.length, c1.length)
    for s, kv1 in enumerate(cross):
        kvs = [kv for g in range(n) for kv in state.cross_kv[g][s]]
        for i in range(2):
            assert _gap(torch.cat([kv[i] for kv in kvs], 1), kv1[i]) <= TOL
    for i, leaf1 in enumerate(rec):
        copies = [c for g in range(n) for c in state.recurrent[g][i]]
        for copy in copies:
            assert all(_same(a, b) for a, b in zip(copy, copies[0]))
        assert all(_gap(a, b) <= TOL for a, b in zip(copies[0], leaf1))


def _spans(n_cells: int, n: int) -> list:
    return [hi - lo for lo, hi in (tp._span(c, n_cells, n)
                                   for c in range(n_cells))]


# ---------------------------------------------------- against one device
CASES = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s}" for a, s in CASES])
def test_folded_serving_matches_the_one_device_steps(arch, shape):
    cfg = _cfg(arch)
    model = _model(cfg)
    lm = _lm(model, shape)
    gap, one, state = _serve_both(cfg, lm, model)
    assert gap <= TOL, gap
    _check_state(cfg, one, state, lm)
    n_cells = shape[0] * shape[1]
    for layer in range(len(state.caches[0])):
        assert [c.k.shape[1] for g in state.caches
                for c in g[layer]] == _spans(n_cells, S)
    if cfg.family == "vlm":
        for s in range(len(state.cross_kv[0])):
            assert [k.shape[1] for g in state.cross_kv
                    for k, _ in g[s]] == _spans(n_cells, 1024)


def test_greedy_generate_folds_and_flash_runs_on_every_cell(monkeypatch):
    """``serve.greedy_generate`` at batch 1 on a (2, 2) grid equals the one
    device's tokens; its prefill launches the flash kernel once a layer on
    every cell (each group runs the prompt), windowed causal, each on its
    position's query heads."""
    cfg = _cfg("yi_6b")
    model = _model(cfg)
    lm = _lm(model, (2, 2))
    prompt, _ = _inputs(cfg, 1, T, 2)
    want = serve.greedy_generate(model, cfg, prompt, 6, S)
    launches = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        launches.append((tuple(q.shape), kw.get("window")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    got = serve.greedy_generate(lm, cfg, prompt, 6, S)
    assert torch.equal(got, want)
    assert launches == [((1, T, cfg.n_heads // 2, cfg.hd), WINDOW)] * (
        4 * cfg.n_layers)


# ------------------------------------------------------------------ edges
def test_idle_cells_add_exactly_zero_across_the_data_boundary(monkeypatch):
    """Over (2, 2), the steps whose window straddles slot 520 (the
    data-group boundary): cells 1 and 2 read, cells 0 and 3 none. Each
    attention call's four slices (cell order): the idle cells' exponentials,
    sums and P·V partials are +0.0 bit for bit; the reading cells'
    are not."""
    cfg = _cfg("yi_6b")
    model = _model(cfg)
    lm = _lm(model, (2, 2))
    prompt, _ = _inputs(cfg, 1, T, 3)
    _, state = serve.make_prefill_step(cfg, S)(lm, prompt)
    seen = []
    real_exp, real_pv = attn.slice_exp, attn.slice_pv

    def exp_spy(scores, mx):
        out = real_exp(scores, mx)
        seen.append(["exp", *out])
        return out

    def pv_spy(e, total, v):
        out = real_pv(e, total, v)
        seen.append(["pv", out])
        return out

    monkeypatch.setattr(attn, "slice_exp", exp_spy)
    monkeypatch.setattr(attn, "slice_pv", pv_spy)
    dec = serve.make_decode_step(cfg)
    for i in range(N_DECODE):
        seen.clear()
        length = int(state.caches[0][0][0].length[0])
        _, state = dec(lm, _tokens(cfg, 1, 20 + i), state)
        reading = {c for c in range(4)
                   if any(lo < c * 260 + 260 and c * 260 <= hi
                          for lo, hi in [(length - WINDOW + 1, length)])}
        assert reading == ({1} if length < 520 else {1, 2})
        assert len(seen) == 8 * cfg.n_layers
        for layer in range(cfg.n_layers):
            calls = seen[8 * layer:8 * (layer + 1)]
            exps, pvs = calls[:4], calls[4:]
            for c in range(4):
                tensors = exps[c][1:] + pvs[c][1:]
                zero = all(_same(t, torch.zeros_like(t)) for t in tensors)
                assert zero == (c not in reading), (length, layer, c)


@pytest.mark.parametrize("arch", ["yi_6b", "zamba2_7b"])
@pytest.mark.parametrize("first", [259, 519])
def test_writes_at_a_cell_boundary(arch, first):
    """A one-device state of seeded K/V with the row at slot 259 (the last
    of cell 0; the next step writes cell 1's first) or 519 (the last of
    cell 1 in data group 0; the next step writes cell 2's, in group 1),
    placed over (2, 2) by ``place_state``: two decode steps write each
    entry on the cell holding its slot and nowhere else; logits and caches
    within ``TOL`` of the one device's."""
    cfg = _cfg(arch)
    model = _model(cfg)
    lm = _lm(model, (2, 2))
    one = tf.init_decode_state(cfg, 1, S, device="cpu")
    caches, _, _ = tp_serve.leaves_by_kind(cfg, one)
    rs = np.random.RandomState(4)
    with torch.inference_mode():
        for c in caches:
            for x in (c.k, c.v):
                x[:, :first] = torch.from_numpy(
                    rs.randn(1, first, *x.shape[2:]).astype(np.float32))
            c.length.fill_(first)
    state = tp_serve.place_state(lm, cfg, _clone_one(one))
    before = [[(c.k.clone(), c.v.clone()) for g in state.caches
               for c in g[i]] for i in range(len(caches))]
    dec = serve.make_decode_step(cfg)
    for i in range(2):
        tok = _tokens(cfg, 1, 30 + i)
        l1, one = dec(model, tok, one)
        l2, state = dec(lm, tok, state)
        assert _gap(l1, l2) <= TOL
    _check_state(cfg, one, state, lm)
    want = {(first // 260, first), ((first + 1) // 260, first + 1)}
    for i, was in enumerate(before):
        cells = [c for g in state.caches for c in g[i]]
        for cell, (c, (k0, v0)) in enumerate(zip(cells, was)):
            for now, then in ((c.k, k0), (c.v, v0)):
                at = torch.nonzero((now != then).any(-1).any(-1)[0])
                got = {(cell, int(x) + cell * 260) for x in at.flatten()}
                assert got == {w for w in want if w[0] == cell}, (i, cell)
            assert int(c.length[0]) == first + 2


def _clone_one(state: tf.DecodeState) -> tf.DecodeState:
    """A one-device state whose tensors are fresh copies of ``state``'s."""
    def each(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, KVCache):
            return KVCache(k=x.k.clone(), v=x.v.clone(),
                           length=x.length.clone())
        if isinstance(x, dict):
            return {k: each(v) for k, v in x.items()}
        if isinstance(x, list):
            return [each(v) for v in x]
        if isinstance(x, tuple):
            return tp_serve.rebuild(x, [each(v) for v in x])
        return x

    return dataclasses.replace(state, **{
        f.name: each(getattr(state, f.name))
        for f in dataclasses.fields(state)})


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=str)
def test_every_data_groups_recurrent_copy_is_bit_equal(arch, shape):
    """After the prefill and after every decode step, each cell's copy of
    every recurrent state (SSM state and conv tail; the cells' states)
    holds the bits of cell (0, 0)'s: every group ran the same stream."""
    cfg = _cfg(arch)
    lm = _lm(_model(cfg), shape)
    prompt, _ = _inputs(cfg, 1, T, 5)
    _, state = serve.make_prefill_step(cfg, S)(lm, prompt)
    dec = serve.make_decode_step(cfg)
    for i in range(N_DECODE + 1):
        for layer in range(len(state.recurrent[0])):
            copies = [c for g in state.recurrent for c in g[layer]]
            assert len(copies) == shape[0] * shape[1]
            for copy in copies[1:]:
                assert all(_same(a, b) for a, b in zip(copy, copies[0]))
        if i < N_DECODE:
            _, state = dec(lm, _tokens(cfg, 1, 40 + i), state)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=str)
def test_a_batch_that_neither_folds_nor_splits_raises(shape):
    cfg = _cfg("yi_6b")
    lm = _lm(_model(cfg), shape)
    with pytest.raises(ValueError, match="does not split"):
        tp_serve.group_rows(lm, 3)
    with pytest.raises(ValueError, match="does not split"):
        tp_serve.init_state(lm, cfg, 3, S)
    with pytest.raises(ValueError, match="does not split"):
        serve.make_prefill_step(cfg, S)(lm, _inputs(cfg, 3, 8, 6)[0])
    assert tp_serve.group_rows(lm, 1) == [(0, 1)] * shape[0]
    assert tp_serve.group_rows(lm, 4) == [(g * 4 // shape[0], 4 // shape[0])
                                          for g in range(shape[0])]


def test_a_group_of_two_data_positions_does_not_fold():
    cfg = _cfg("yi_6b")
    lm = fsdp.shard(_model(cfg), tmesh.LogicalMesh((2, 1), AXES, "cpu"),
                    groups=[((CPU,), range(0, 2))])
    with pytest.raises(ValueError, match="one data position"):
        tp_serve.group_rows(lm, 1)


# ------------------------------------------------------------- placement
def _cell_bytes(state) -> list:
    out = []
    for g in range(len(state.caches)):
        m = len(state.caches[g][0]) if state.caches[g] else len(
            state.recurrent[g][0])
        for j in range(m):
            ts = [t for layer in state.caches[g]
                  for t in (layer[j].k, layer[j].v, layer[j].length)]
            for tree in (state.cross_kv, state.recurrent):
                ts += [t for layer in (tree[g] if tree else [])
                       for t in layer[j]]
            out.append(sum(t.numel() * t.element_size() for t in ts))
    return out


def _predicted(cfg, mesh, cache_len: int) -> int:
    """One device's bytes of a one-row decode state under the rewritten
    rules (``dryrun.step_rules``)."""
    shape = specs.InputShape("long", cache_len, 1, "decode")
    rules = dryrun.step_rules(mesh, shape, None)
    assert rules["batch"] is None and rules["kv_seq"] == ("data", "model")
    leaves = specs._state_leaves(specs.input_specs(cfg, shape)["state"])
    return sum(dryrun.shard_bytes(x.shape, x.dtype, spec, mesh.shape)
               for x, spec in zip(leaves, specs.input_pspecs(
                   cfg, shape, rules)["state"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_placed_bytes_equal_the_rewritten_specs(arch, shape):
    """Every cell holds the bytes ``input_pspecs`` places there under the
    rewritten rules: the prefill's state, an empty one (``init_state``)
    and a one-device state placed (``place_state``)."""
    cfg = _cfg(arch)
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    model = _model(cfg)
    lm = _lm(model, shape)
    want = [_predicted(cfg, mesh, S)] * (shape[0] * shape[1])
    prompt, img = _inputs(cfg, 1, 8, 7)
    _, state = serve.make_prefill_step(cfg, S)(lm, prompt, img)
    _, one = serve.make_prefill_step(cfg, S)(model, prompt, img)
    empty = tp_serve.init_state(lm, cfg, 1, S)
    placed = tp_serve.place_state(lm, cfg, one)
    for st in (state, empty, placed):
        assert st.folded and _cell_bytes(st) == want
    assert len(tp_serve.state_tensors(empty)) == len(
        tp_serve.state_tensors(state)) == len(tp_serve.state_tensors(placed))
    for a, b in zip(tp_serve.state_tensors(state),
                    tp_serve.state_tensors(placed)):
        assert a.shape == b.shape and _gap(a, b) <= TOL


def test_yi6b_long_500k_state_on_the_production_grid():
    """Yi-6B whole, long-context variant, ``long_500k`` (one row, 524,288
    slots) over data 16 x model 16 on the meta device: cell ``(g, j)``
    holds slots ``[c 2048, (c+1) 2048)``, ``c = 16 g + j``, of every KV
    head and layer, the rewritten specs' bytes."""
    cfg = configs.get("yi_6b").long_context_variant()
    meta = torch.device("meta")
    mesh = tmesh.LogicalMesh((16, 16), AXES, "meta")
    lm = fsdp.empty(cfg, mesh, groups=[((meta,) * 16, range(g, g + 1))
                                       for g in range(16)])
    state = tp_serve.init_state(lm, cfg, 1, 524288)
    assert state.folded
    c = state.caches[15][31][15]
    assert tuple(c.k.shape) == (1, 2048, 4, 128) and c.k.device == meta
    assert tp_serve.slots(16 * 15 + 15, 256, 524288) == (522240, 2048)
    want = _predicted(cfg, mesh, 524288)
    assert want == 32 * (2 * 2048 * 4 * 128 * 2 + 4)
    assert _cell_bytes(state) == [want] * 256


# ------------------------------------------ the reference's sharded steps
REF_SERVE = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro import configs
from repro.models import transformer as tf
from repro.models.sharding import logical_axis_rules
from repro.launch import shardings as shd
from repro.launch import serve, specs
from repro.launch.mesh import logical_rules
families, shapes, out_path, T, S, n_decode, window = json.loads(sys.argv[1])
out = {}
for arch, over in families.items():
    cfg = dataclasses.replace(
        configs.reduced(configs.get(arch)).long_context_variant(),
        dtype="float32", **over)
    if cfg.window is not None:
        cfg = dataclasses.replace(cfg, window=window)
    params0 = tf.init_params(cfg, jax.random.key(0))
    rs = np.random.RandomState(5)
    prompt = rs.randint(0, cfg.vocab, (1, T)).astype(np.int32)
    img = (rs.randn(1, cfg.n_image_tokens, cfg.d_model).astype(np.float32)
           if cfg.family == "vlm" else None)
    out[arch] = {"prompt": prompt, "image_embeds": img}
    for shape in shapes:
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        rules = logical_rules(mesh)
        # repro/launch/dryrun.py's rewrite for a global batch of 1
        batch_axes = rules["batch"] if isinstance(rules["batch"], tuple) \
            else (rules["batch"],)
        rules = {**rules, "kv_seq": tuple(a for a in batch_axes if a)
                 + ("model",), "batch": None}
        pshapes = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params0)
        params = jax.device_put(params0, shd.named(
            shd.param_specs(pshapes, rules, mesh), mesh))
        try:
            with logical_axis_rules(mesh, rules):
                ins = specs.input_pspecs(
                    cfg, specs.InputShape("serve", S, 1, "prefill"), rules)
                args = [params, jax.device_put(jnp.asarray(prompt),
                        NamedSharding(mesh, ins["tokens"]))]
                if img is not None:
                    args.append(jax.device_put(jnp.asarray(img), NamedSharding(
                        mesh, ins["image_embeds"])))
                logits, state = jax.jit(serve.make_prefill_step(cfg, S))(
                    *args)
                ish = specs.input_pspecs(
                    cfg, specs.InputShape("serve", S, 1, "decode"), rules)
                state = jax.device_put(state, shd.named(ish["state"], mesh))
                step = jax.jit(serve.make_decode_step(cfg),
                               donate_argnums=(2,))
                got, fed = [np.asarray(logits)], []
                tok = serve.next_token(logits)
                for _ in range(n_decode):
                    fed.append(np.asarray(tok))
                    logits, state = step(params, tok, state)
                    got.append(np.asarray(logits))
                    tok = serve.next_token(logits)
            res = {"logits": got, "tokens": fed}
        except Exception as e:
            res = {"error": f"{type(e).__name__}: {e}"[:3000]}
        out[arch][str(tuple(shape))] = res
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


class ServeReference:
    """The reference's serving steps of every decoding family under the
    rewritten rules on each of ``REF_SHAPES``, in a subprocess started at
    once."""

    def __init__(self, tmp_path):
        self.out = tmp_path / "serve_long.pkl"
        arg = json.dumps([FAMILIES, [list(s) for s in REF_SHAPES],
                          str(self.out), T, S, N_DECODE, WINDOW])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_SERVE, arg], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            try:
                _, err = self.proc.communicate(timeout=900)
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


@pytest.fixture(scope="module", autouse=True)
def serve_ref(tmp_path_factory):
    job = ServeReference(tmp_path_factory.mktemp("serve_long"))
    yield job
    job.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", REF_SHAPES, ids=str)
def test_folded_serving_matches_the_reference_mesh(arch, shape, serve_ref):
    ref = serve_ref.result()[arch]
    want = ref[str(shape)]
    assert "error" not in want, want.get("error")
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get(arch)).long_context_variant(),
        dtype="float32", **FAMILIES[arch])
    if jcfg.window is not None:
        jcfg = dataclasses.replace(jcfg, window=WINDOW)
    p0 = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.key(0)))
    lm = fsdp.shard_reference(p0, cfg, tmesh.LogicalMesh(shape, AXES, "cpu"),
                              groups=grid(shape[1], shape[0]))
    img = (None if ref["image_embeds"] is None
           else torch.from_numpy(ref["image_embeds"]))
    logits, state = serve.make_prefill_step(cfg, S)(
        lm, torch.from_numpy(ref["prompt"]), img)
    assert state.folded
    gaps = [float(np.abs(logits.numpy() - want["logits"][0]).max())]
    step = serve.make_decode_step(cfg)
    for tok, w in zip(want["tokens"], want["logits"][1:]):
        logits, state = step(lm, torch.from_numpy(tok), state)
        gaps.append(float(np.abs(logits.numpy() - w).max()))
    assert len(gaps) == N_DECODE + 1 and max(gaps) <= TOL, gaps


# -------------------------------------------- the grid steps, as they stood
# ``launch/tp_serve.py``'s functions that the fold changed, as they stood
# before it, verbatim (bar the names and the docstrings; the helpers they
# call are ``tp_serve``'s, unchanged): the data-1 and batch > 1 paths must
# give their bits
def _p_group_rows(lm, n_rows: int) -> list:
    if n_rows % lm.n_data:
        raise ValueError(f"batch {n_rows} does not split over {lm.n_data} "
                         "data positions")
    per = n_rows // lm.n_data
    return [(pos.start * per, len(pos) * per) for _, pos in lm.groups]


def _p_init_state(lm, cfg: ArchConfig, batch: int,
                  cache_len: int) -> GridState:
    check_decode(cfg)
    dtype = tf.DTYPES[cfg.dtype]
    kv_dt = torch.int8 if cfg.kv_dtype == "int8" else dtype
    caches, cross, rec = [], [], []
    for g, (_, rows) in enumerate(_p_group_rows(lm, batch)):
        devs = tp.GridView(lm, g).devices
        calls, images, layers = leaves_by_kind(cfg, tf.init_decode_state(
            cfg, rows, 1, device="meta"))

        def kv(n, d, dt):
            return torch.zeros((rows, n, cfg.n_kv_heads, cfg.hd), dtype=dt,
                               device=d)

        caches.append([[KVCache(
            k=kv(n, d, kv_dt), v=kv(n, d, kv_dt),
            length=torch.zeros((rows,), dtype=torch.int32, device=d))
            for j, d in enumerate(devs)
            for n in [slots(j, lm.n_model, cache_len)[1]]]
            for _ in calls])
        cross.append([[(kv(n, d, dtype), kv(n, d, dtype))
                       for j, d in enumerate(devs)
                       for n in [image_slots(j, lm.n_model,
                                             cfg.n_image_tokens)[1]]]
                      for _ in images])
        rec.append([[rebuild(c, [torch.zeros(x.shape, dtype=x.dtype,
                                             device=d) for x in c])
                     for d in devs] for c in layers])
    return GridState(caches=caches, cache_len=cache_len,
                     cross_kv=cross if cfg.family == "vlm" else None,
                     recurrent=rec if has_recurrent(cfg) else None)


def _p_relayout(kvs, m: int, cache_len: int, exchange: bool) -> tuple:
    t = kvs[0][0].shape[1]
    spans = [slots(j, m, cache_len) for j in range(m)]
    pieces = [(min(off, t), max(0, min(off + n, t) - off))
              for off, n in spans]
    if exchange:
        ks = tp.all_to_all([k for k, _ in kvs], 1, 2, pieces)
        vs = tp.all_to_all([v for _, v in kvs], 1, 2, pieces)
    else:
        ks = [k.narrow(1, *p) for (k, _), p in zip(kvs, pieces)]
        vs = [v.narrow(1, *p) for (_, v), p in zip(kvs, pieces)]
    return ks, vs, spans


def _p_to_cache(kvs, m: int, cache_len: int, exchange: bool) -> list:
    ks, vs, spans = _p_relayout(kvs, m, cache_len, exchange)
    t = kvs[0][0].shape[1]
    out = []
    for k, v, (_, n) in zip(ks, vs, spans):
        kc = k.new_zeros((k.shape[0], n) + tuple(k.shape[2:]))
        vc = v.new_zeros(kc.shape)
        kc[:, :k.shape[1]] = k
        vc[:, :v.shape[1]] = v
        out.append(KVCache(k=kc, v=vc, length=torch.full(
            (k.shape[0],), t, dtype=torch.int32, device=k.device)))
    return out


def _p_group_prefill(view, cfg: ArchConfig, tokens: torch.Tensor,
                  cache_len: int, image_embeds=None) -> tuple:
    t = tokens.shape[1]
    audio = cfg.family == "audio"
    if t > cache_len and not audio:
        raise ValueError(f"a prompt of {t} tokens does not fit a cache of "
                         f"{cache_len} slots")
    m = view.m
    if cfg.family == "vlm":
        for j in range(m):
            image_slots(j, m, cfg.n_image_tokens)
    exchange = kv_by_exchange(m, cfg, cache_len)
    st = tp.Stream(view.devices, t)
    if audio:           # tokens are frame embeddings [B, T, d]
        xs = st.inputs(tokens.to(tf.DTYPES[cfg.dtype]))
    else:
        xs = tp.embed(view, cfg, st, tokens)
    caches, cross, rec = [], [], []

    def self_layer(prefix, xs):
        hs = st.gather(tp._norms(view, prefix + "attn_norm.", xs, cfg))
        parts, kvs = prefill_attention(view, prefix + "attn.", hs, cfg,
                                       window=cfg.window, exchange=exchange,
                                       causal=not audio, keep=not audio)
        xs = [x + a for x, a in zip(xs, st.reduce(parts))]
        del hs, parts
        if not audio:
            caches.append(_p_to_cache(kvs, m, cache_len, exchange))
        del kvs
        xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
        return xs

    if cfg.xlstm:
        for i in range(cfg.n_layers):
            xs, state = xlstm_prefill(view, f"{'slstm' if i % 2 == 0 else
                                                'mlstm'}.{i // 2}.", cfg,
                                      st, xs)
            rec.append(state)
    elif cfg.family == "vlm":
        n_img = cfg.n_image_tokens
        imgs = [tf._image_embeds(cfg, image_embeds, xs[0].new_empty(
            0, device=d)) for d in view.devices]
        cross_ex = kv_by_exchange(m, cfg, n_img)
        for s in range(tf.n_super(cfg)):
            for i in range(cfg.cross_attn_every):
                xs = self_layer(f"self_blocks.{s}.{i}.", xs)
            prefix = f"cross_blocks.{s}."
            hs = st.gather(tp._norms(view, prefix + "attn_norm.", xs, cfg))
            parts, kvs = prefill_attention(
                view, prefix + "attn.", hs, cfg, window=None,
                exchange=cross_ex, causal=False, kv_srcs=imgs)
            xs = [x + a for x, a in zip(xs, st.reduce(parts))]
            del hs, parts
            ks, vs, _ = _p_relayout(kvs, m, n_img, cross_ex)
            cross.append(list(zip(ks, vs)))
            del kvs
            xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
    elif cfg.family == "hybrid":
        for s in range(tf.n_super(cfg)):
            for i in range(cfg.shared_attn_every):
                xs, state = ssm_prefill(view, f"ssm_blocks.{s}.{i}.", cfg,
                                        st, xs)
                rec.append(state)
            xs = self_layer("shared_block.", xs)
    else:       # dense, MoE, the audio encoder
        for i in range(cfg.n_layers):
            xs = self_layer(f"blocks.{i}.", xs)
    last = (tp.broadcast(xs[-1][:, -1:], view.devices) if st.split
            else [x[:, -1:] for x in xs])
    return logits(view, cfg, last), caches, cross, rec


@torch.inference_mode()
def _p_prefill(lm, cfg: ArchConfig, tokens: torch.Tensor, cache_len: int,
            image_embeds: Optional[torch.Tensor] = None) -> tuple:
    outs, caches, cross, rec = [], [], [], []
    for g, (r0, n) in enumerate(_p_group_rows(lm, tokens.shape[0])):
        view = tp.GridView(lm, g)
        img = None if image_embeds is None else image_embeds[r0:r0 + n]
        lg, c, x, r = _p_group_prefill(view, cfg, tokens[r0:r0 + n].to(
            view.devices[0]), cache_len, img)
        outs.append(lg.to(lm.device))
        caches.append(c)
        cross.append(x)
        rec.append(r)
    if cfg.family == "audio":
        return torch.cat(outs, 0), None
    return torch.cat(outs, 0), GridState(
        caches=caches, cache_len=cache_len,
        cross_kv=cross if cfg.family == "vlm" else None,
        recurrent=rec if has_recurrent(cfg) else None)


def _p_combine(view, prefix: str, qs, att, lengths, offs, cfg: ArchConfig,
            window: Optional[int], dtype) -> list:
    hd, m = cfg.hd, view.m
    scores = [attn.slice_scores(qj, ka, lj, off, hd=hd, window=window)
              for qj, (ka, _), lj, off in zip(qs, att, lengths, offs)]
    mx = tp.all_max([x.float().amax(-1) for x in scores])
    es = [attn.slice_exp(x, mj) for x, mj in zip(scores, mx)]
    del scores
    total = tp.all_reduce([sj for _, sj in es])
    pv = [attn.slice_pv(e, tot, va).flatten(2)
          for (e, _), tot, (_, va) in zip(es, total, att)]
    del es
    wos = [share(view, j, prefix + "wo", 0) for j in range(m)]
    os_ = tp.reduce_scatter(pv, 2, [piece for _, piece in wos])
    return [o.to(dtype) @ w for o, (w, _) in zip(os_, wos)]


def _p_decode_attention(view, prefix: str, hs, caches, cfg: ArchConfig,
                     cache_len: int) -> list:
    hd, m = cfg.hd, view.m
    dtype = hs[0].dtype
    q, k, v = [[x.reshape(x.shape[0], 1, -1, hd) for x in xs]
               for xs in columns(view, prefix, hs, ("wq", "wk", "wv"))]
    entries = [attn.decode_entry(qj, kj, vj, c.length, rope=cfg.rope,
                                 kv_dtype=c.k.dtype)
               for qj, kj, vj, c in zip(q, k, v, caches)]
    offs = [slots(j, m, cache_len)[0] for j in range(m)]
    att = []
    for (_, kn, vn), c, off in zip(entries, caches, offs):
        attn.write_slice(c, kn, vn, off)
        att.append(attn.attended(c, dtype))
    qs = [qj for qj, _, _ in entries]
    if split_over_model(cache_len):
        parts = _p_combine(view, prefix, qs, att, [c.length for c in caches],
                        offs, cfg, cfg.window, dtype)
    else:
        parts = own_heads(view, prefix, hs, qs, att, [
            attn.decode_valid(c.length, 0, ka.shape[1],
                              cfg.window)[:, None, None, None]
            for c, (ka, _) in zip(caches, att)], cfg)
    for c in caches:
        c.length += 1
    return parts


def _p_cross_attention(view, prefix: str, hs, kvs, cfg: ArchConfig) -> list:
    hd, m = cfg.hd, view.m
    [q] = columns(view, prefix, hs, ("wq",))
    qs = [x.reshape(x.shape[0], 1, -1, hd) for x in q]
    if split_over_model(cfg.n_image_tokens):
        offs = [image_slots(j, m, cfg.n_image_tokens)[0] for j in range(m)]
        return _p_combine(view, prefix, qs, kvs, [None] * m, offs, cfg, None,
                       hs[0].dtype)
    return own_heads(view, prefix, hs, qs, kvs, [None] * m, cfg)


def _p_group_decode(view, cfg: ArchConfig, token: torch.Tensor, caches,
                 cache_len: int, cross=None, rec=None) -> torch.Tensor:
    st = tp.Stream(view.devices, 1)
    xs = tp.embed(view, cfg, st, token)
    calls = iter(caches)

    def self_layer(prefix, xs):
        hs = tp._norms(view, prefix + "attn_norm.", xs, cfg)
        parts = _p_decode_attention(view, prefix + "attn.", hs, next(calls),
                                 cfg, cache_len)
        xs = [x + a for x, a in zip(xs, st.reduce(parts))]
        xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
        return xs

    if cfg.xlstm:
        for i in range(cfg.n_layers):
            prefix = f"{'slstm' if i % 2 == 0 else 'mlstm'}.{i // 2}."
            xs, rec[i] = xlstm_decode(view, prefix, cfg, st, xs, rec[i])
    elif cfg.family == "vlm":
        for s in range(tf.n_super(cfg)):
            for i in range(cfg.cross_attn_every):
                xs = self_layer(f"self_blocks.{s}.{i}.", xs)
            prefix = f"cross_blocks.{s}."
            hs = tp._norms(view, prefix + "attn_norm.", xs, cfg)
            parts = _p_cross_attention(view, prefix + "attn.", hs, cross[s],
                                    cfg)
            xs = [x + a for x, a in zip(xs, st.reduce(parts))]
            xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
    elif cfg.family == "hybrid":
        per = cfg.shared_attn_every
        for s in range(tf.n_super(cfg)):
            for i in range(per):
                li = s * per + i
                xs, rec[li] = ssm_decode(view, f"ssm_blocks.{s}.{i}.", cfg,
                                         st, xs, rec[li])
            xs = self_layer("shared_block.", xs)
    else:
        for i in range(cfg.n_layers):
            xs = self_layer(f"blocks.{i}.", xs)
    return logits(view, cfg, xs)


@torch.inference_mode()
def _p_decode_step(lm, cfg: ArchConfig, token: torch.Tensor,
                state: GridState) -> tuple:
    check_decode(cfg)
    outs = []
    for g, (r0, n) in enumerate(_p_group_rows(lm, token.shape[0])):
        view = tp.GridView(lm, g)
        outs.append(_p_group_decode(
            view, cfg, token[r0:r0 + n].to(view.devices[0]),
            state.caches[g], state.cache_len,
            None if state.cross_kv is None else state.cross_kv[g],
            None if state.recurrent is None else state.recurrent[g]).to(
                lm.device))
    return torch.cat(outs, 0), state


BITS_CASES = [(a, s, b) for a in ARCHS for s, b in (((1, 2), 1), ((1, 2), 4),
                                                    ((2, 2), 4))]


@pytest.mark.parametrize("arch,shape,batch", BITS_CASES,
                         ids=[f"{a}-{s}-B{b}" for a, s, b in BITS_CASES])
def test_data_1_and_batches_above_1_are_bit_equal_to_their_earlier_code(
        arch, shape, batch):
    """The prefill of ``batch`` rows into 1,040 slots and three decode
    steps, and ``init_state``, on the grid against the functions as they
    stood: logits and every state tensor bit-equal (at data 1 a batch of
    one row folds over its one group, the earlier layout)."""
    cfg = _cfg(arch)
    lm = _lm(_model(cfg), shape)
    prompt, img = _inputs(cfg, batch, 16, 8)
    la, a = tp_serve.prefill(lm, cfg, prompt, S, image_embeds=img)
    lb, b = _p_prefill(lm, cfg, prompt, S, image_embeds=img)
    outs = [(la, lb)]
    for i in range(3):
        tok = _tokens(cfg, batch, 50 + i)
        outs.append((tp_serve.decode_step(lm, cfg, tok, a)[0],
                     _p_decode_step(lm, cfg, tok, b)[0]))
    assert all(_same(x, y) for x, y in outs)
    for x, y in zip(tp_serve.state_tensors(a), tp_serve.state_tensors(b)):
        assert _same(x, y)
    for x, y in zip(tp_serve.state_tensors(tp_serve.init_state(
            lm, cfg, batch, S)), tp_serve.state_tensors(
            _p_init_state(lm, cfg, batch, S))):
        assert _same(x, y)
