"""Port: serving over a participant's ``(data, model)`` grid
(``launch/tp_serve.py`` through ``launch/serve.py``'s steps; the decode's
slice pieces in ``models/attention.py``), against the port's one-device
serving steps and the JAX reference's real sharded steps.

Without a card the grid's positions share the CPU through an explicit
list (``((cpu,) * m, range(g, g + 1))``), as in ``tests/test_torch_tp.py``.
Reduced configurations in f32; prompts of 16 tokens into a cache of 1,040
slots, so the reference's rule (a KV cache's sequence splits over
``model`` from 1,024 slots) splits it; a cache of 40 slots stays whole.

* **Against the one-device steps**: reduced Yi-6B and DeepSeek-MoE-16B,
  prefill and 4 decode steps over (1, 2), (1, 3), (1, 4) and (2, 2),
  logits within 2e-5 and the caches' slots equal to the one-device cache's
  within it. Yi-6B at model 4 has 4 query heads over 2 KV heads: more
  positions than KV heads, so its K/V are read whole and narrowed.
* **Against the reference's real ``jax.jit`` steps** on Auto-axis meshes
  (1, 2), (2, 2) and (1, 4) of 4 fake CPU devices, parameters placed by
  ``param_specs`` and the decode state by ``input_pspecs`` under
  ``logical_axis_rules`` (a subprocess started with the module): prefill
  logits and 4 decode steps' (fed the reference's greedy tokens) within
  2e-5.
* **The cache's edges**: a cache below 1,024 slots (whole on every
  position); a slice with no slot to read adds exactly 0; writes at the
  slice boundary (slots 519 / 520 of 1,040 over 2) on the position that
  holds the slot and nowhere else; a full row gets no write; a window; an
  int8 cache.
* **Placement**: the state's bytes on every cell equal
  ``dryrun.shard_bytes`` of ``specs.input_pspecs``' specs (a CPU grid, and
  Yi-6B's ``decode_32k`` state on the production meta grid).
* **The other families** are served over the grid too:
  ``tests/test_torch_tp_serve_families.py``.
* **Repeatability**: two grid decodes from one cloned state are bit-equal,
  and the grid prefill launches the flash kernel once a layer a position.
* **The one-device path** (``decode_self_attention``, ``prefill_cache``,
  ``transformer.prefill`` / ``decode_step``) is bit-equal, in f32 and
  bf16, to those functions as they stood before the grid's slice pieces
  joined ``models/attention.py``, kept verbatim below.
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, fsdp, serve, specs, tp, tp_serve  # noqa: E402,E501
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.layers import apply_rope  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
AXES = ("data", "model")
CPU = torch.device("cpu")
TOL = 2e-5                 # f32 logits and cache slots, grid vs one device
B, T, S, S_WHOLE = 4, 16, 1040, 40
N_DECODE = 4
SHAPES = [(1, 2), (1, 3), (1, 4), (2, 2)]
REF_SHAPES = [(1, 2), (2, 2), (1, 4)]
ARCHS = ["yi_6b", "deepseek_moe_16b"]


def grid(m: int, n_groups: int = 1) -> list:
    return [((CPU,) * m, range(g, g + 1)) for g in range(n_groups)]


def _cfg(arch: str = "yi_6b", **over):
    return dataclasses.replace(configs.reduced(configs.get(arch)),
                               dtype="float32", **over)


def _model(cfg, seed: int = 0):
    return tf.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def _lm(model, shape) -> fsdp.ShardedLM:
    n_data, m = shape
    return fsdp.shard(model, tmesh.LogicalMesh(shape, AXES, "cpu"),
                      groups=grid(m, n_data))


def _tokens(cfg, rows: int, t: int, seed: int) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, cfg.vocab, (rows, t))
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


def _whole_cache(state: tp_serve.GridState, g: int, i: int) -> tuple:
    """Layer ``i``'s cache of data group ``g`` as one device holds it:
    the positions' slices in slot order (one copy where it is whole)."""
    cs = state.caches[g][i]
    if not state.split:
        return cs[0].k, cs[0].v, cs[0].length
    return (torch.cat([c.k for c in cs], 1), torch.cat([c.v for c in cs], 1),
            cs[0].length)


def _check_caches(one: tf.DecodeState, state: tp_serve.GridState,
                  lm) -> None:
    """Every layer's grid cache equals the one-device cache of its rows
    (K/V within ``TOL``, lengths equal on every position)."""
    rows = tp_serve.group_rows(lm, one.caches[0].k.shape[0])
    for g, (r0, n) in enumerate(rows):
        for i, c1 in enumerate(one.caches):
            k, v, length = _whole_cache(state, g, i)
            assert _gap(k, c1.k[r0:r0 + n]) <= TOL, (g, i)
            assert _gap(v, c1.v[r0:r0 + n]) <= TOL, (g, i)
            for c in state.caches[g][i]:
                assert torch.equal(c.length, c1.length[r0:r0 + n])
                assert torch.equal(c.length, length)


def _serve_both(cfg, lm, model, prompt, cache_len, tokens, *, state1=None,
                state2=None) -> tuple:
    """Prefill (unless states are given) and a decode step a token on the
    one device and on the grid: the largest logit gap, the states."""
    gaps = []
    if state1 is None:
        l1, state1 = serve.make_prefill_step(cfg, cache_len)(model, prompt)
        l2, state2 = serve.make_prefill_step(cfg, cache_len)(lm, prompt)
        gaps.append(_gap(l1, l2))
        assert l2.shape == l1.shape == (prompt.shape[0], 1, cfg.vocab)
    dec = serve.make_decode_step(cfg)
    for tok in tokens:
        l1, state1 = dec(model, tok, state1)
        l2, state2 = dec(lm, tok, state2)
        gaps.append(_gap(l1, l2))
    return max(gaps), state1, state2


# ---------------------------------------------------- against one device
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_grid_serving_matches_the_one_device_steps(arch, shape):
    cfg = _cfg(arch)
    model = _model(cfg)
    lm = _lm(model, shape)
    prompt = _tokens(cfg, B, T, 1)
    toks = [_tokens(cfg, B, 1, 10 + i) for i in range(N_DECODE)]
    gap, one, state = _serve_both(cfg, lm, model, prompt, S, toks)
    assert gap <= TOL, gap
    assert state.split and state.cache_len == S
    _check_caches(one, state, lm)
    m = shape[1]
    for group in state.caches:
        for layer in group:
            assert [c.k.shape[1] for c in layer] == [
                hi - lo for lo, hi in (tp._span(j, m, S) for j in range(m))]


def test_greedy_generate_on_the_grid_equals_one_device():
    cfg = _cfg()
    model = _model(cfg)
    prompt = _tokens(cfg, B, T, 2)
    want = serve.greedy_generate(model, cfg, prompt, 6, S)
    got = serve.greedy_generate(_lm(model, (1, 2)), cfg, prompt, 6, S)
    assert torch.equal(got, want)


def test_more_positions_than_kv_heads_narrow_whole_kv(monkeypatch):
    """Yi-6B reduced at model 4 (2 KV heads): no all-to-all; at model 2
    each position's KV heads are its own chunk and the relayout is one
    all-to-all for K and one for V a layer."""
    cfg = _cfg()
    model = _model(cfg)
    calls = []
    real = tp.all_to_all

    def spy(xs, split_dim, cat_dim, pieces=None):
        calls.append(xs[0].dim())
        return real(xs, split_dim, cat_dim, pieces)

    monkeypatch.setattr(tp, "all_to_all", spy)
    for m, want in ((2, 2 * cfg.n_layers), (4, 0)):
        calls.clear()
        assert tp_serve.kv_by_exchange(m, cfg, S) == (want > 0)
        serve.make_prefill_step(cfg, S)(_lm(model, (1, m)),
                                        _tokens(cfg, B, T, 1))
        assert calls.count(4) == want


# ------------------------------------------------------- the cache's edges
def test_a_whole_cache_below_1024_slots():
    cfg = _cfg()
    model = _model(cfg)
    lm = _lm(model, (1, 2))
    toks = [_tokens(cfg, B, 1, 20 + i) for i in range(N_DECODE)]
    gap, one, state = _serve_both(cfg, lm, model, _tokens(cfg, B, T, 3),
                                  S_WHOLE, toks)
    assert gap <= TOL and not state.split
    for layer in state.caches[0]:
        assert all(tuple(c.k.shape) == (B, S_WHOLE, cfg.n_kv_heads, cfg.hd)
                   for c in layer)
        assert _same(layer[0].k, layer[1].k)      # bit-equal copies
    _check_caches(one, state, lm)


@pytest.mark.parametrize("window_slot", [None, 12])
def test_a_slice_with_no_slot_to_read_adds_exactly_zero(window_slot):
    """Two slices of 8 slots. Without a window the rows read slots 0..3 /
    0..5, all on slice 0; with a window of 3 ending at slot 12 they lie on
    slice 1 alone. The other slice's exponentials, sum and P·V partial are
    +0.0, and the combine equals the reading slice's alone, bit for bit,
    and ``attend`` over the whole within 1e-6."""
    gen = torch.Generator().manual_seed(4)
    hd, n_kv = 8, 2
    q = torch.randn((2, 1, 4, hd), generator=gen)
    k = torch.randn((2, 16, n_kv, hd), generator=gen)
    v = torch.randn((2, 16, n_kv, hd), generator=gen)
    window = None if window_slot is None else 3
    length = (torch.tensor([3, 5], dtype=torch.int32) if window is None
              else torch.tensor([window_slot] * 2, dtype=torch.int32))
    scores = [attn.slice_scores(q, k[:, off:off + 8], length, off, hd=hd,
                                window=window) for off in (0, 8)]
    mx = tp.all_max([s.float().amax(-1) for s in scores])
    es = [attn.slice_exp(s, x) for s, x in zip(scores, mx)]
    idle = 1 if window is None else 0
    e, s_idle = es[idle]
    assert _same(e, torch.zeros_like(e)) and _same(s_idle,
                                                   torch.zeros_like(s_idle))
    total = tp.all_reduce([s for _, s in es])
    assert _same(total[0], es[1 - idle][1])
    pv = [attn.slice_pv(e, t, v[:, off:off + 8])
          for (e, _), t, off in zip(es, total, (0, 8))]
    assert _same(pv[idle], torch.zeros_like(pv[idle]))
    combined = tp.reduce_scatter([p.flatten(2) for p in pv], 2,
                                 [(0, 4 * hd)] * 2)[0]
    assert _same(combined, pv[1 - idle].flatten(2))
    mask = attn.decode_valid(length, 0, 16, window)[:, None, None, None]
    want = attn.attend(q, k, v, mask, hd)
    assert _gap(combined.reshape(want.shape), want) <= 1e-6


@torch.inference_mode()
def _set_lengths(one, state, lengths) -> None:
    for c in one.caches:
        c.length.copy_(lengths)
    for group in state.caches:
        for layer in group:
            for c in layer:
                c.length.copy_(lengths)


def test_writes_at_the_slice_boundary_and_a_full_row():
    """Rows at slots 519 and 520 (the last of position 0, the first of
    position 1), 1039 (the last slot: the next step finds the row full)
    and 1045 (full from the start). Each entry is written on the position
    holding its slot and nowhere else; a full row gets no write."""
    cfg = _cfg()
    model = _model(cfg)
    lm = _lm(model, (1, 2))
    prompt = _tokens(cfg, B, T, 5)
    _, one = serve.make_prefill_step(cfg, S)(model, prompt)
    _, state = serve.make_prefill_step(cfg, S)(lm, prompt)
    lengths = torch.tensor([519, 520, 1039, 1045], dtype=torch.int32)
    _set_lengths(one, state, lengths)
    before = [[(c.k.clone(), c.v.clone()) for c in layer]
              for layer in state.caches[0]]
    toks = [_tokens(cfg, B, 1, 30 + i) for i in range(2)]
    gap, one, state = _serve_both(cfg, lm, model, prompt, S, toks,
                                  state1=one, state2=state)
    assert gap <= TOL, gap
    _check_caches(one, state, lm)
    half = S // 2
    want = [{(0, 519)}, {(0, 520), (1, 520), (1, 521), (2, 1039)}]
    for layer, was in zip(state.caches[0], before):
        for j, (c, (k0, v0)) in enumerate(zip(layer, was)):
            for now, then in ((c.k, k0), (c.v, v0)):
                rows, at = torch.nonzero((now != then).any(-1).any(-1),
                                         as_tuple=True)
                assert {(int(r), int(x) + j * half)
                        for r, x in zip(rows, at)} == want[j], j
            assert c.length.tolist() == [521, 522, 1041, 1047]


def test_a_window():
    cfg = _cfg(window=8)
    model = _model(cfg)
    lm = _lm(model, (1, 2))
    toks = [_tokens(cfg, B, 1, 40 + i) for i in range(N_DECODE)]
    gap, one, state = _serve_both(cfg, lm, model, _tokens(cfg, B, T, 6), S,
                                  toks)
    assert gap <= TOL, gap
    _check_caches(one, state, lm)


@pytest.mark.parametrize("cache_len", [S, S_WHOLE])
def test_an_int8_cache(cache_len):
    """Empty int8 caches (``init_decode_state`` / ``init_state``) through
    six decode steps: logits within ``TOL``, the stored int8 entries
    equal."""
    cfg = _cfg(kv_dtype="int8")
    model = _model(cfg)
    lm = _lm(model, (1, 2))
    one = tf.init_decode_state(cfg, B, cache_len, device="cpu")
    state = tp_serve.init_state(lm, cfg, B, cache_len)
    assert state.caches[0][0][0].k.dtype == torch.int8
    toks = [_tokens(cfg, B, 1, 50 + i) for i in range(6)]
    gap, one, state = _serve_both(cfg, lm, model, None, cache_len, toks,
                                  state1=one, state2=state)
    assert gap <= TOL, gap
    for i, c1 in enumerate(one.caches):
        k, v, _ = _whole_cache(state, 0, i)
        assert torch.equal(k, c1.k) and torch.equal(v, c1.v)


# ------------------------------------------------------------- placement
def _cell_bytes(state, lm) -> list:
    out = []
    for g, group in enumerate(state.caches):
        for j in range(lm.n_model):
            out.append(sum(t.numel() * t.element_size() for layer in group
                           for t in (layer[j].k, layer[j].v,
                                     layer[j].length)))
    return out


def _predicted(cfg, mesh, batch: int, cache_len: int) -> int:
    rules = tmesh.logical_rules(mesh)
    shape = specs.InputShape("serve", cache_len, batch, "decode")
    leaves = specs._state_leaves(specs.input_specs(cfg, shape)["state"])
    return sum(dryrun.shard_bytes(x.shape, x.dtype, spec, mesh.shape)
               for x, spec in zip(leaves, specs.input_pspecs(
                   cfg, shape, rules)["state"]))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("cache_len", [S, S_WHOLE])
def test_placed_bytes_equal_the_specs(shape, cache_len):
    cfg = _cfg()
    model = _model(cfg)
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    lm = _lm(model, shape)
    want = _predicted(cfg, mesh, B, cache_len)
    _, state = serve.make_prefill_step(cfg, cache_len)(
        lm, _tokens(cfg, B, T, 7))
    assert _cell_bytes(state, lm) == [want] * (shape[0] * shape[1])
    empty = tp_serve.init_state(lm, cfg, B, cache_len)
    assert _cell_bytes(empty, lm) == [want] * (shape[0] * shape[1])


def test_yi6b_decode_32k_state_on_the_production_grid():
    """Yi-6B whole, ``decode_32k`` (128 rows, 32,768 slots) over data 16 x
    model 16 on the meta device: every cell holds 8 rows and 2,048 slots
    of every KV head, the specs' bytes."""
    cfg = configs.get("yi_6b")
    meta = torch.device("meta")
    mesh = tmesh.LogicalMesh((16, 16), AXES, "meta")
    lm = fsdp.empty(cfg, mesh, groups=[((meta,) * 16, range(g, g + 1))
                                       for g in range(16)])
    state = tp_serve.init_state(lm, cfg, 128, 32768)
    c = state.caches[15][31][15]
    assert tuple(c.k.shape) == (8, 2048, 4, 128) and c.k.device == meta
    want = _predicted(cfg, mesh, 128, 32768)
    assert want == 32 * (2 * 8 * 2048 * 4 * 128 * 2 + 8 * 4)
    assert _cell_bytes(state, lm) == [want] * 256


# --------------------------------------------------------- repeatability
def _clone(state: tp_serve.GridState) -> tp_serve.GridState:
    return dataclasses.replace(state, caches=[
        [[KVCache(k=c.k.clone(), v=c.v.clone(), length=c.length.clone())
          for c in layer] for layer in group] for group in state.caches])


@pytest.mark.parametrize("arch", ARCHS)
def test_two_grid_decodes_are_bit_equal_and_flash_runs_a_layer_a_position(
        arch, monkeypatch):
    cfg = _cfg(arch)
    lm = _lm(_model(cfg), (1, 2))
    launches = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        launches.append(tuple(q.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    _, state = serve.make_prefill_step(cfg, S)(lm, _tokens(cfg, B, T, 8))
    assert len(launches) == 2 * cfg.n_layers
    assert all(s[2] == cfg.n_heads // 2 for s in launches)
    a, b = _clone(state), _clone(state)
    dec = serve.make_decode_step(cfg)
    for i in range(3):
        tok = _tokens(cfg, B, 1, 60 + i)
        la, a = dec(lm, tok, a)
        lb, b = dec(lm, tok, b)
        assert _same(la, lb)
    for ga, gb in zip(tp_serve.state_tensors(a), tp_serve.state_tensors(b)):
        assert _same(ga, gb)


# ------------------------------------ the one-device path, as it stood
# ``models/attention.py``'s one-device functions as they stood before the
# grid's slice pieces joined it, verbatim (bar the names): the current
# functions must give their bits
def _p_split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _p_q_groups(q, n_kv):
    b, t, h, hd = q.shape
    return q.reshape(b, t, n_kv, h // n_kv, hd)


def _p_attend(q, k, v, mask, hd):
    b, t, h, _ = q.shape
    n_kv = k.shape[2]
    qg = _p_q_groups(q, n_kv)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.tensor(attn.NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, hd)


def _p_qkv(p, x, positions, *, n_heads, n_kv, hd, rope):
    q = _p_split_heads(x @ p["wq"], n_heads, hd)
    k = _p_split_heads(x @ p["wk"], n_kv, hd)
    v = _p_split_heads(x @ p["wv"], n_kv, hd)
    return apply_rope(q, positions, rope), apply_rope(k, positions, rope), v


def _p_decode_self_attention(p, x, cache, *, n_heads, n_kv, hd,
                             rope="default", window: Optional[int] = None):
    b, t, _ = x.shape
    if t != 1:
        raise ValueError(f"decode step consumes exactly one new token, "
                         f"got {t}")
    pos = cache.length[:, None]
    q, k_new, v_new = _p_qkv(p, x, pos, n_heads=n_heads, n_kv=n_kv, hd=hd,
                             rope=rope)
    s = cache.k.shape[1]
    quant = cache.k.dtype == torch.int8
    if quant:
        k_new = torch.clamp(torch.round(k_new.float() / attn.KV_QSCALE),
                            -127, 127).to(torch.int8)
        v_new = torch.clamp(torch.round(v_new.float() / attn.KV_QSCALE),
                            -127, 127).to(torch.int8)
    rows = torch.arange(b, device=x.device)
    slot = cache.length.clamp(max=s - 1).long()
    fits = (cache.length < s)[:, None, None]
    cache.k[rows, slot] = torch.where(fits, k_new[:, 0], cache.k[rows, slot])
    cache.v[rows, slot] = torch.where(fits, v_new[:, 0], cache.v[rows, slot])
    if quant:
        k_att = cache.k.to(x.dtype) * attn.KV_QSCALE
        v_att = cache.v.to(x.dtype) * attn.KV_QSCALE
    else:
        k_att, v_att = cache.k, cache.v
    ki = torch.arange(s, device=x.device)[None, :]
    valid = ki <= cache.length[:, None]
    if window is not None:
        valid &= ki > (cache.length[:, None] - window)
    mask = valid[:, None, None, None, :]
    out = _p_attend(q, k_att, v_att, mask, hd)
    out = out.reshape(b, 1, n_heads * hd) @ p["wo"]
    cache.length += 1
    return out, cache


def _p_prefill_cache(p, x, *, n_heads, n_kv, hd, rope="default",
                     window: Optional[int] = None,
                     cache_len: Optional[int] = None):
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _p_qkv(p, x, positions, n_heads=n_heads, n_kv=n_kv, hd=hd,
                     rope=rope)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    out = out.reshape(b, t, n_heads * hd) @ p["wo"]
    s = cache_len or t
    kc = k.new_zeros((b, s, n_kv, hd))
    vc = v.new_zeros((b, s, n_kv, hd))
    kc[:, :t] = k
    vc[:, :t] = v
    length = torch.full((b,), t, dtype=torch.int32, device=x.device)
    return out, KVCache(k=kc, v=vc, length=length)


def _one_device_run(cfg, model, prompt, toks) -> list:
    out = []
    logits, state = tf.prefill(model, cfg, prompt, S_WHOLE)
    out.append(logits)
    for tok in toks:
        logits, state = tf.decode_step(model, cfg, tok, state)
        out.append(logits)
    return out + [t for c in state.caches for t in (c.k, c.v, c.length)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi_6b", "granite_20b"])
def test_one_device_path_is_bit_equal_to_its_earlier_code(arch, dtype,
                                                    monkeypatch):
    cfg = dataclasses.replace(_cfg(arch), dtype=dtype, window=None)
    model = _model(cfg)
    prompt = _tokens(cfg, B, T, 9)
    toks = [_tokens(cfg, B, 1, 70 + i) for i in range(3)]
    got = _one_device_run(cfg, model, prompt, toks)
    monkeypatch.setattr(attn, "decode_self_attention",
                        _p_decode_self_attention)
    monkeypatch.setattr(attn, "prefill_cache", _p_prefill_cache)
    want = _one_device_run(cfg, model, prompt, toks)
    monkeypatch.undo()
    assert all(_same(a, b) for a, b in zip(got, want))
    # the layer functions themselves, with a window and an int8 cache
    gen = torch.Generator().manual_seed(11)
    dt = tf.DTYPES[dtype]
    p = {n: t for n, t in model.blocks[0]["attn"].items()}
    x = torch.randn((B, T, cfg.d_model), generator=gen).to(dt)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
              rope=cfg.rope)
    for window in (None, 5):
        with torch.inference_mode():
            oa, ca = attn.prefill_cache(p, x, window=window, cache_len=24,
                                        **kw)
            ob, cb = _p_prefill_cache(p, x, window=window, cache_len=24,
                                      **kw)
            assert _same(oa, ob) and _same(ca.k, cb.k) and _same(ca.v, cb.v)
            for kv_int8 in (False, True):
                if kv_int8:
                    ca.k = attn.quantize_kv(ca.k)
                    ca.v = attn.quantize_kv(ca.v)
                    cb.k, cb.v = ca.k.clone(), ca.v.clone()
                for step in range(3):
                    xt = torch.randn((B, 1, cfg.d_model),
                                     generator=gen).to(dt)
                    oa, ca = attn.decode_self_attention(p, xt, ca,
                                                        window=window, **kw)
                    ob, cb = _p_decode_self_attention(p, xt, cb,
                                                      window=window, **kw)
                    assert _same(oa, ob) and _same(ca.k, cb.k)
                    assert _same(ca.length, cb.length)


# ------------------------------------------ the reference's sharded steps
REF_SERVE = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.models import transformer as tf
from repro.models.sharding import logical_axis_rules
from repro.launch import shardings as shd
from repro.launch import serve, specs
from repro.launch.mesh import logical_rules
archs, shapes, out_path, B, T, S, n_decode = json.loads(sys.argv[1])
out = {}
for arch in archs:
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                              dtype="float32")
    params0 = tf.init_params(cfg, jax.random.key(0))
    rs = np.random.RandomState(5)
    prompt = rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    out[arch] = {"prompt": prompt}
    for shape in shapes:
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        rules = logical_rules(mesh)
        pshapes = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params0)
        params = jax.device_put(params0, shd.named(
            shd.param_specs(pshapes, rules, mesh), mesh))
        with logical_axis_rules(mesh, rules):
            toks = jax.device_put(jnp.asarray(prompt),
                                  NamedSharding(mesh, P(rules["batch"], None)))
            logits, state = jax.jit(serve.make_prefill_step(cfg, S))(params,
                                                                    toks)
            ish = specs.input_pspecs(
                cfg, specs.InputShape("serve", S, B, "decode"), rules)
            state = jax.device_put(state, shd.named(ish["state"], mesh))
            step = jax.jit(serve.make_decode_step(cfg), donate_argnums=(2,))
            got, fed = [np.asarray(logits)], []
            tok = serve.next_token(logits)
            for _ in range(n_decode):
                fed.append(np.asarray(tok))
                logits, state = step(params, tok, state)
                got.append(np.asarray(logits))
                tok = serve.next_token(logits)
        out[arch][str(tuple(shape))] = {"logits": got, "tokens": fed}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


class ServeReference:
    """The reference's serving steps on each of ``REF_SHAPES``, in a
    subprocess started at once."""

    def __init__(self, tmp_path):
        self.out = tmp_path / "serve.pkl"
        arg = json.dumps([ARCHS, [list(s) for s in REF_SHAPES],
                          str(self.out), B, T, S, N_DECODE])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_SERVE, arg], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
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


@pytest.fixture(scope="module", autouse=True)
def serve_ref(tmp_path_factory):
    job = ServeReference(tmp_path_factory.mktemp("serve"))
    yield job
    job.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", REF_SHAPES, ids=str)
def test_grid_serving_matches_the_reference_mesh(arch, shape, serve_ref):
    ref = serve_ref.result()[arch]
    want = ref[str(shape)]
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               dtype="float32")
    p0 = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.key(0)))
    lm = fsdp.shard_reference(p0, cfg, tmesh.LogicalMesh(shape, AXES, "cpu"),
                              groups=grid(shape[1], shape[0]))
    logits, state = serve.make_prefill_step(cfg, S)(
        lm, torch.from_numpy(ref["prompt"]))
    gaps = [float(np.abs(logits.numpy() - want["logits"][0]).max())]
    step = serve.make_decode_step(cfg)
    for tok, w in zip(want["tokens"], want["logits"][1:]):
        logits, state = step(lm, torch.from_numpy(tok), state)
        gaps.append(float(np.abs(logits.numpy() - w).max()))
    assert len(gaps) == N_DECODE + 1 and max(gaps) <= TOL, gaps
