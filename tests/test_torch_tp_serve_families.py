"""Port: serving the VLM, hybrid, xLSTM and audio families over a
participant's ``(data, model)`` grid (``launch/tp_serve.py`` through
``launch/serve.py``'s steps), against the port's one-device serving steps
and the JAX reference's real sharded steps.

Without a card the grid's positions share the CPU through an explicit
list (``((cpu,) * m, range(g, g + 1))``), as in
``tests/test_torch_tp_serve.py``. Reduced configurations in f32; prompts of
16 tokens into a cache of 1,040 slots, so a KV cache's sequence splits over
``model`` (the reference's rule, from 1,024 slots); the VLM with 1,024 image
tokens, so its cross K/V split too.

* **Against the one-device steps**: reduced Llama-3.2-Vision-90B, Zamba2-7B
  and xLSTM-125M, prefill and 4 decode steps over (1, 2), (1, 3), (1, 4)
  and (2, 2), and xLSTM at (1, 8), where four positions hold no head:
  logits within 2e-5, and every leaf of the state (self caches, cross K/V,
  the SSM state and conv tail, the cells' states) equal to the one-device
  state's within it, the recurrent states bit-equal on every position.
  HuBERT-XLarge: the encode's logits.
* **Against the reference's real ``jax.jit`` steps** on Auto-axis meshes
  (1, 2), (2, 2) and (1, 4) of 4 fake CPU devices, parameters placed by
  ``param_specs``, the prompt (frames, image embeddings) by
  ``input_pspecs`` and the decode state by ``input_pspecs`` (a subprocess
  started with the module): prefill logits and 4 decode steps' (fed the
  reference's greedy tokens) within 2e-5.
* **Edges**: cross K/V below 1,024 image tokens (whole on every position);
  a hybrid cache below 1,024 slots; uneven head spans (Zamba2's reduced 16
  SSM heads as 5 / 5 / 6 at model 3, with one and two B/C groups); the tied
  head against ``h @ embed.T``; the placed bytes against the specs'
  prediction; two grid decodes bit-equal; the flash kernel once a layer a
  position; an audio decode and an image split that leaves a position no
  token raise ``ValueError``; the recurrent decode reads no more weight
  across positions than the training forward.
* **Bits unchanged**: the one-device serving steps of the VLM, hybrid and
  xLSTM, whose Mamba2 and mLSTM decode steps now run on a range of heads,
  and the dense and MoE grid steps, whose attention pieces the families
  now share, are bit-equal, in f32 and bf16, to those functions as they
  stood before, kept verbatim below.
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
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.layers import apply_norm, apply_rope  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
AXES = ("data", "model")
CPU = torch.device("cpu")
TOL = 2e-5                 # f32 logits and state leaves, grid vs one device
B, T, S, S_WHOLE = 4, 16, 1040, 40
N_DECODE = 4
SHAPES = [(1, 2), (1, 3), (1, 4), (2, 2)]
REF_SHAPES = [(1, 2), (2, 2), (1, 4)]
# the family configurations: the VLM with 1,024 image tokens (its cross
# K/V split over model)
FAMILIES = {"llama32_vision_90b": {"n_image_tokens": 1024},
            "zamba2_7b": {}, "xlstm_125m": {}, "hubert_xlarge": {}}
DECODING = ["llama32_vision_90b", "zamba2_7b", "xlstm_125m"]


def grid(m: int, n_groups: int = 1) -> list:
    return [((CPU,) * m, range(g, g + 1)) for g in range(n_groups)]


def _cfg(arch: str, **over):
    return dataclasses.replace(configs.reduced(configs.get(arch)), **{
        "dtype": "float32", **FAMILIES.get(arch, {}), **over})


def _model(cfg, seed: int = 0):
    return tf.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def _lm(model, shape) -> fsdp.ShardedLM:
    n_data, m = shape
    return fsdp.shard(model, tmesh.LogicalMesh(shape, AXES, "cpu"),
                      groups=grid(m, n_data))


def _inputs(cfg, rows: int, t: int, seed: int) -> tuple:
    """A prompt (frames for the encoder) and the VLM's image embeddings,
    from numpy."""
    rs = np.random.RandomState(seed)
    if cfg.family == "audio":
        prompt = torch.from_numpy(rs.randn(rows, t, cfg.d_model)
                                  .astype(np.float32))
    else:
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


def _serve_both(cfg, lm, model, cache_len, seed: int = 1) -> tuple:
    """Prefill and ``N_DECODE`` decode steps on the one device and on the
    grid, fed the same tokens: the largest logit gap, both states."""
    prompt, img = _inputs(cfg, B, T, seed)
    l1, one = serve.make_prefill_step(cfg, cache_len)(model, prompt, img)
    l2, state = serve.make_prefill_step(cfg, cache_len)(lm, prompt, img)
    assert l2.shape == l1.shape == (B, 1, cfg.vocab)
    gaps = [_gap(l1, l2)]
    dec = serve.make_decode_step(cfg)
    for i in range(N_DECODE):
        tok = _tokens(cfg, B, 10 + i)
        l1, one = dec(model, tok, one)
        l2, state = dec(lm, tok, state)
        gaps.append(_gap(l1, l2))
    return max(gaps), one, state


def _check_state(cfg, one: tf.DecodeState, state: tp_serve.GridState,
                 lm) -> None:
    """Every leaf of the grid state against the one-device state of its
    rows: the slices of a split cache / cross K/V in order, a whole copy
    on each position otherwise; the recurrent states bit-equal on every
    position."""
    caches, cross, rec = tp_serve.leaves_by_kind(cfg, one)
    rows = tp_serve.group_rows(lm, B)
    assert len(state.caches[0]) == len(caches)
    for g, (r0, n) in enumerate(rows):
        for c1, cs in zip(caches, state.caches[g]):
            pairs = ([(torch.cat([c.k for c in cs], 1),
                       torch.cat([c.v for c in cs], 1))] if state.split
                     else [(c.k, c.v) for c in cs])
            for k, v in pairs:
                assert _gap(k, c1.k[r0:r0 + n]) <= TOL
                assert _gap(v, c1.v[r0:r0 + n]) <= TOL
            for c in cs:
                assert torch.equal(c.length, c1.length[r0:r0 + n])
        for kv1, kvs in zip(cross, state.cross_kv[g] if cross else []):
            split = tp_serve.split_over_model(cfg.n_image_tokens)
            for i in range(2):
                got = ([torch.cat([kv[i] for kv in kvs], 1)] if split
                       else [kv[i] for kv in kvs])
                for x in got:
                    assert _gap(x, kv1[i][r0:r0 + n]) <= TOL
        assert len(rec) == len(state.recurrent[g] if rec else [])
        for leaf1, copies in zip(rec, state.recurrent[g] if rec else []):
            for copy in copies:
                for a, b in zip(copy, copies[0]):
                    assert _same(a, b)
                for a, b in zip(copy, leaf1):
                    assert _gap(a, b[r0:r0 + n]) <= TOL


# ---------------------------------------------------- against one device
ONE_DEVICE_CASES = [(a, s) for a in DECODING for s in SHAPES] + [
    ("xlstm_125m", (1, 8))]


@pytest.mark.parametrize("arch,shape", ONE_DEVICE_CASES,
                         ids=[f"{a}-{s}" for a, s in ONE_DEVICE_CASES])
def test_grid_serving_matches_the_one_device_steps(arch, shape):
    cfg = _cfg(arch)
    model = _model(cfg)
    lm = _lm(model, shape)
    gap, one, state = _serve_both(cfg, lm, model, S)
    assert gap <= TOL, gap
    assert state.split and state.cache_len == S
    _check_state(cfg, one, state, lm)
    m = shape[1]
    if cfg.family == "vlm":
        for group in state.cross_kv:
            for kvs in group:
                assert [k.shape[1] for k, _ in kvs] == [
                    hi - lo for lo, hi in (tp._span(j, m, 1024)
                                           for j in range(m))]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_audio_encode_matches_the_one_device_encode(shape):
    cfg = _cfg("hubert_xlarge")
    model = _model(cfg)
    prompt, _ = _inputs(cfg, B, T, 2)
    l1, none1 = serve.make_prefill_step(cfg, S)(model, prompt)
    l2, none2 = serve.make_prefill_step(cfg, S)(_lm(model, shape), prompt)
    assert none1 is None and none2 is None
    assert l2.shape == l1.shape == (B, 1, cfg.vocab)
    assert _gap(l1, l2) <= TOL


# ------------------------------------------------------------------ edges
def test_cross_kv_below_1024_image_tokens_stays_whole():
    """The reduced VLM's 16 image tokens: every position holds the cross
    K/V whole (bit-equal copies), each reads its own heads over them."""
    cfg = _cfg("llama32_vision_90b", n_image_tokens=16)
    model = _model(cfg)
    lm = _lm(model, (1, 2))
    gap, one, state = _serve_both(cfg, lm, model, S, seed=3)
    assert gap <= TOL, gap
    for kvs in state.cross_kv[0]:
        assert all(tuple(k.shape) == (B, 16, cfg.n_kv_heads, cfg.hd)
                   for k, _ in kvs)
        assert _same(kvs[0][0], kvs[1][0]) and _same(kvs[0][1], kvs[1][1])
    _check_state(cfg, one, state, lm)


def test_a_hybrid_cache_below_1024_slots():
    cfg = _cfg("zamba2_7b")
    model = _model(cfg)
    lm = _lm(model, (1, 2))
    gap, one, state = _serve_both(cfg, lm, model, S_WHOLE, seed=4)
    assert gap <= TOL and not state.split
    for layer in state.caches[0]:
        assert all(tuple(c.k.shape) == (B, S_WHOLE, cfg.n_kv_heads, cfg.hd)
                   for c in layer)
    _check_state(cfg, one, state, lm)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_uneven_ssm_head_spans(n_groups):
    """Zamba2's reduced 16 SSM heads over 3 positions (5 / 5 / 6): with two
    B/C groups of 8 heads, group 0 is read by positions 0 and 1 and owned
    by 0, group 1 by positions 1 and 2 and owned by 1 (the position holding
    head 8); the conv tail is the one device's."""
    cfg = _cfg("zamba2_7b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=n_groups))
    _, n_heads, _ = ssm_mod.dims(cfg.d_model, cfg.ssm)
    assert [tp._span(j, 3, n_heads) for j in range(3)] == [(0, 5), (5, 10),
                                                           (10, 16)]
    model = _model(cfg)
    lm = _lm(model, (1, 3))
    gap, one, state = _serve_both(cfg, lm, model, S, seed=5)
    assert gap <= TOL, gap
    _check_state(cfg, one, state, lm)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_the_tied_head_against_h_embed_t(m):
    """xLSTM's tied head over ``m`` positions: each position's feature
    columns of ``embed`` (256 over 3: 85 / 85 / 86), the partial logits
    reduced in position order, against ``final_norm(h) @ embed.T``."""
    cfg = _cfg("xlstm_125m")
    model = _model(cfg)
    lm = _lm(model, (1, m))
    view = tp.GridView(lm, 0)
    h = torch.from_numpy(np.random.RandomState(6).randn(B, 1, cfg.d_model)
                         .astype(np.float32))
    with torch.inference_mode():
        got = tp_serve.logits(view, cfg, [h] * m)
        want = apply_norm(model.final_norm, h, cfg.norm) @ model.embed.T
    assert got.shape == (B, 1, cfg.vocab)
    assert _gap(got, want) <= TOL


def _cell_bytes(state, lm) -> list:
    out = []
    for g in range(len(state.caches)):
        for j in range(lm.n_model):
            ts = [t for layer in state.caches[g]
                  for t in (layer[j].k, layer[j].v, layer[j].length)]
            for tree in (state.cross_kv, state.recurrent):
                ts += [t for layer in (tree[g] if tree else [])
                       for t in layer[j]]
            out.append(sum(t.numel() * t.element_size() for t in ts))
    return out


def _predicted(cfg, mesh, batch: int, cache_len: int) -> int:
    rules = tmesh.logical_rules(mesh)
    shape = specs.InputShape("serve", cache_len, batch, "decode")
    leaves = specs._state_leaves(specs.input_specs(cfg, shape)["state"])
    return sum(dryrun.shard_bytes(x.shape, x.dtype, spec, mesh.shape)
               for x, spec in zip(leaves, specs.input_pspecs(
                   cfg, shape, rules)["state"]))


@pytest.mark.parametrize("arch", DECODING)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=str)
def test_placed_bytes_equal_the_specs(arch, shape):
    """Every cell holds the bytes ``input_pspecs`` places there: the
    prefill's state and an empty one (``init_state``)."""
    cfg = _cfg(arch)
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    lm = _lm(_model(cfg), shape)
    want = _predicted(cfg, mesh, B, S)
    prompt, img = _inputs(cfg, B, T, 7)
    _, state = serve.make_prefill_step(cfg, S)(lm, prompt, img)
    assert _cell_bytes(state, lm) == [want] * (shape[0] * shape[1])
    empty = tp_serve.init_state(lm, cfg, B, S)
    assert _cell_bytes(empty, lm) == [want] * (shape[0] * shape[1])
    assert len(tp_serve.state_tensors(empty)) == len(
        tp_serve.state_tensors(state))


def test_zamba2_decode_32k_state_on_the_production_grid():
    """Zamba2-7B whole, ``decode_32k`` (128 rows, 32,768 slots) over data
    16 x model 16 on the meta device: every cell holds 8 rows, 2,048 slots
    of the shared block's 9 caches and every SSM layer's state and conv
    tail whole, the specs' bytes."""
    cfg = configs.get("zamba2_7b")
    meta = torch.device("meta")
    mesh = tmesh.LogicalMesh((16, 16), AXES, "meta")
    lm = fsdp.empty(cfg, mesh, groups=[((meta,) * 16, range(g, g + 1))
                                       for g in range(16)])
    state = tp_serve.init_state(lm, cfg, 128, 32768)
    c = state.caches[15][8][15]
    assert tuple(c.k.shape) == (8, 2048, 32, 112) and c.k.device == meta
    r = state.recurrent[15][80][15]
    assert tuple(r.state.shape) == (8, 112, 64, 64)
    assert tuple(r.conv.shape) == (8, 3, 7296)
    assert _cell_bytes(state, lm) == [_predicted(cfg, mesh, 128, 32768)] * 256


def _clone_check(cfg, shape=(1, 2)) -> None:
    lm = _lm(_model(cfg), shape)
    prompt, img = _inputs(cfg, B, T, 8)
    _, state = serve.make_prefill_step(cfg, S)(lm, prompt, img)
    a, b = tp_serve.clone_state(state), tp_serve.clone_state(state)
    dec = serve.make_decode_step(cfg)
    for i in range(3):
        tok = _tokens(cfg, B, 60 + i)
        la, a = dec(lm, tok, a)
        lb, b = dec(lm, tok, b)
        assert _same(la, lb)
    for ga, gb in zip(tp_serve.state_tensors(a), tp_serve.state_tensors(b)):
        assert _same(ga, gb)


@pytest.mark.parametrize("arch", DECODING)
def test_two_grid_decodes_are_bit_equal(arch):
    _clone_check(_cfg(arch))


@pytest.mark.parametrize("arch", ["llama32_vision_90b", "zamba2_7b",
                                  "hubert_xlarge"])
def test_flash_runs_once_a_layer_a_position(arch, monkeypatch):
    """The VLM's self and cross layers (the cross non-causal, against
    1,024 image tokens), the hybrid's shared block once a super-block, the
    encoder's layers (non-causal): one flash launch a layer a position, on
    that position's heads."""
    cfg = _cfg(arch, n_layers=4)
    lm = _lm(_model(cfg), (1, 2))
    launches = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        launches.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    prompt, img = _inputs(cfg, B, T, 9)
    serve.make_prefill_step(cfg, S)(lm, prompt, img)
    want = tf.n_super(cfg) if cfg.family == "hybrid" else cfg.n_layers
    assert len(launches) == 2 * want
    assert all(q[2] == cfg.n_heads // 2 for q, _, _ in launches)
    causal = [c for _, _, c in launches]
    if cfg.family == "vlm":
        assert causal.count(False) == 2 * tf.n_super(cfg)
        assert {k[1] for _, k, c in launches if not c} == {1024}
    else:
        assert causal == [cfg.family == "hybrid"] * len(causal)


def test_an_audio_grid_decode_raises():
    cfg = _cfg("hubert_xlarge")
    lm = _lm(_model(cfg), (1, 2))
    with pytest.raises(ValueError, match="audio"):
        serve.make_decode_step(cfg)(lm, _tokens(cfg, B, 0), None)
    with pytest.raises(ValueError, match="audio"):
        tp_serve.init_state(lm, cfg, B, S)


def test_an_image_split_that_leaves_a_position_none_raises():
    assert tp_serve.image_slots(1, 2, 1024) == (512, 512)
    assert tp_serve.image_slots(2, 3, 16) == (0, 16)       # whole
    with pytest.raises(ValueError, match="none"):
        tp_serve.image_slots(0, 1025, 1024)


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m"])
def test_the_recurrent_decode_reads_no_more_weight_than_training(arch):
    """Position 0's reads of other positions' weight chunks in one decode
    step are no more than the training forward's (the same column runs;
    the shared block's decode reads none) at model 2, where some of a
    position's heads' columns lie in the other chunk."""
    cfg = _cfg(arch)
    lm = _lm(_model(cfg), (1, 2))
    prompt, _ = _inputs(cfg, B, T, 11)
    _, state = serve.make_prefill_step(cfg, S)(lm, prompt)
    with dryrun.counting_tp() as dec:
        serve.make_decode_step(cfg)(lm, _tokens(cfg, B, 12), state)
    with dryrun.counting_tp() as fwd, torch.no_grad():
        tp.hidden(tp.GridView(lm, 0), cfg, {"tokens": prompt,
                                            "labels": prompt})
    assert 0 < dec[dryrun.WEIGHT_READS]["bytes"] <= fwd[
        dryrun.WEIGHT_READS]["bytes"]


# --------------------------------- the one-device steps, as they stood
# ``models/ssm.py``'s and ``models/xlstm.py``'s decode steps as they stood
# before they ran on a range of heads, verbatim (bar the names)
def _p_ssd_decode_step(p, x, cache, spec):
    F = torch.nn.functional
    b, _, d_model = x.shape
    d_inner, n_heads, _ = ssm_mod.dims(d_model, spec)

    z, xbc, dt = ssm_mod._split_proj(x @ p["in_proj"], d_inner, spec)
    ctx = torch.cat([cache.conv, xbc], dim=1)
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", ctx, p["conv_w"])
                   + p["conv_b"])
    new_conv = ctx[:, 1:, :]
    xs, bh, ch = ssm_mod._heads(xbc_t, spec, (0, n_heads), n_heads)

    dtv = ssm_mod.softplus(dt[:, 0].float() + p["dt_bias"])
    a = torch.exp(dtv * (-torch.exp(p["A_log"])))
    xs_f = xs.float()
    s = cache.state * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", bh.float() * dtv[..., None], xs_f)
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), s)
    y = y + xs_f * p["D"][None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], ssm_mod.SSMCache(state=s, conv=new_conv)


def _p_mlstm_decode_step(p, x, cache, n_heads):
    b = x.shape[0]
    d_inner, dh = xlstm_mod._cell_dims(x.shape[-1], n_heads)
    q, k, v, logi, logf, o = xlstm_mod._mlstm_proj(p, x, n_heads, dh)
    c, n, m = cache
    it, ft = logi[:, 0], logf[:, 0]
    m_new = torch.maximum(ft + m, it)
    i_g = torch.exp(it - m_new)[..., None]
    f_g = torch.exp(ft + m - m_new)[..., None]
    q0, k0, v0 = q[:, 0], k[:, 0], v[:, 0]
    c_new = f_g[..., None] * c + i_g[..., None] * (v0[..., :, None]
                                                   * k0[..., None, :])
    n_new = f_g * n + i_g * k0
    num = torch.einsum("bhvk,bhk->bhv", c_new, q0)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q0)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    y = (o[:, 0].float() * h).reshape(b, 1, d_inner).to(x.dtype)
    return y @ p["w_out"], (c_new, n_new, m_new)


def _one_device_run(cfg, model) -> list:
    prompt, img = _inputs(cfg, B, T, 13)
    logits, state = tf.prefill(model, cfg, prompt, S_WHOLE,
                               image_embeds=img)
    out = [logits]
    for i in range(3):
        logits, state = tf.decode_step(model, cfg, _tokens(cfg, B, 70 + i),
                                       state)
        out.append(logits)
    caches, cross, rec = tp_serve.leaves_by_kind(cfg, state)
    return out + [t for c in caches for t in (c.k, c.v, c.length)] + [
        t for leaf in cross + rec for t in leaf]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODING)
def test_one_device_steps_are_bit_equal_to_their_earlier_code(arch, dtype,
                                                            monkeypatch):
    cfg = _cfg(arch, dtype=dtype)
    model = _model(cfg)
    got = _one_device_run(cfg, model)
    monkeypatch.setattr(ssm_mod, "ssd_decode_step", _p_ssd_decode_step)
    monkeypatch.setattr(xlstm_mod, "mlstm_decode_step", _p_mlstm_decode_step)
    want = _one_device_run(cfg, model)
    monkeypatch.undo()
    assert len(got) == len(want)
    assert all(_same(a, b) for a, b in zip(got, want))


# ------------------------------ the dense and MoE grid steps, as they stood
# ``launch/tp_serve.py``'s dense and MoE steps as they stood before the
# other families joined them, verbatim (bar the names; the helpers they
# call that did not change are the module's own)
def _p_prefill_attention(view, prefix, hs, cfg, *, window, exchange):
    hd, n_kv = cfg.hd, cfg.n_kv_heads
    parts, kvs = [], []
    for j, h in enumerate(hs):
        b, t, _ = h.shape
        lo, hi, kmap = tp.query_heads(j, view.m, cfg)
        ka, kb = (kmap[0], kmap[-1] + 1) if exchange else (0, n_kv)
        positions = torch.arange(t, device=h.device)[None, :]
        k = apply_rope(tp.project_heads(view, j, prefix + "wk", h, ka, kb,
                                        hd), positions, cfg.rope)
        v = tp.project_heads(view, j, prefix + "wv", h, ka, kb, hd)
        kvs.append((k, v))
        if hi == lo:
            parts.append(h.new_zeros((b, t, cfg.d_model)))
            continue
        q = apply_rope(tp.project_heads(view, j, prefix + "wq", h, lo, hi,
                                        hd), positions, cfg.rope)
        klo, khi = kmap[0], kmap[-1] + 1
        kq, vq = tp.for_queries(k.narrow(2, klo - ka, khi - klo),
                                v.narrow(2, klo - ka, khi - klo), kmap, klo)
        o = ops.flash_attention(q, kq, vq, causal=True, window=window)
        parts.append(o.reshape(b, t, (hi - lo) * hd)
                     @ view.part(j, prefix + "wo", 0, lo * hd, hi * hd))
    return parts, kvs


def _p_to_cache(kvs, m, cache_len, exchange):
    t = kvs[0][0].shape[1]
    spans = [tp_serve.slots(j, m, cache_len) for j in range(m)]
    pieces = [(min(off, t), max(0, min(off + n, t) - off))
              for off, n in spans]
    if exchange:
        ks = tp.all_to_all([k for k, _ in kvs], 1, 2, pieces)
        vs = tp.all_to_all([v for _, v in kvs], 1, 2, pieces)
    else:
        ks = [k.narrow(1, *p) for (k, _), p in zip(kvs, pieces)]
        vs = [v.narrow(1, *p) for (_, v), p in zip(kvs, pieces)]
    out = []
    for k, v, (_, n) in zip(ks, vs, spans):
        kc = k.new_zeros((k.shape[0], n) + tuple(k.shape[2:]))
        vc = v.new_zeros(kc.shape)
        kc[:, :k.shape[1]] = k
        vc[:, :v.shape[1]] = v
        out.append(KVCache(k=kc, v=vc, length=torch.full(
            (k.shape[0],), t, dtype=torch.int32, device=k.device)))
    return out


def _p_logits(view, cfg, xs):
    hs = tp._norms(view, "final_norm.", xs, cfg)
    parts = []
    for j, h in enumerate(hs):
        lo, hi = tp._span(j, view.m, cfg.vocab)
        parts.append(h @ view.part(j, "lm_head", 1, lo, hi))
    return tp.all_gather(parts, 2)[0]


def _p_group_prefill(view, cfg, tokens, cache_len):
    t = tokens.shape[1]
    m = view.m
    exchange = tp_serve.kv_by_exchange(m, cfg, cache_len)
    st = tp.Stream(view.devices, t)
    xs = tp.embed(view, cfg, st, tokens)
    caches = []
    for i in range(cfg.n_layers):
        prefix = f"blocks.{i}."
        hs = st.gather(tp._norms(view, prefix + "attn_norm.", xs, cfg))
        parts, kvs = _p_prefill_attention(view, prefix + "attn.", hs, cfg,
                                          window=cfg.window,
                                          exchange=exchange)
        xs = [x + a for x, a in zip(xs, st.reduce(parts))]
        del hs, parts
        caches.append(_p_to_cache(kvs, m, cache_len, exchange))
        del kvs
        xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
    last = (tp.broadcast(xs[-1][:, -1:], view.devices) if st.split
            else [x[:, -1:] for x in xs])
    return _p_logits(view, cfg, last), caches


def _p_decode_attention(view, prefix, hs, caches, cfg, cache_len):
    share, slots = tp_serve.share, tp_serve.slots
    hd, m = cfg.hd, view.m
    dtype = hs[0].dtype
    q, k, v = [[x.reshape(x.shape[0], 1, -1, hd) for x in tp.all_gather(
        [h @ share(view, j, prefix + name, 1)[0] for j, h in enumerate(hs)],
        2)] for name in ("wq", "wk", "wv")]
    entries = [attn.decode_entry(qj, kj, vj, c.length, rope=cfg.rope,
                                 kv_dtype=c.k.dtype)
               for qj, kj, vj, c in zip(q, k, v, caches)]
    offs = [slots(j, m, cache_len)[0] for j in range(m)]
    att = []
    for (_, kn, vn), c, off in zip(entries, caches, offs):
        attn.write_slice(c, kn, vn, off)
        att.append(attn.attended(c, dtype))
    parts = []
    if tp_serve.split_over_model(cache_len):
        scores = [attn.slice_scores(qj, ka, c.length, off, hd=hd,
                                    window=cfg.window)
                  for (qj, _, _), (ka, _), c, off in zip(entries, att,
                                                         caches, offs)]
        mx = tp.all_max([x.float().amax(-1) for x in scores])
        es = [attn.slice_exp(x, mj) for x, mj in zip(scores, mx)]
        del scores
        total = tp.all_reduce([sj for _, sj in es])
        pv = [attn.slice_pv(e, tot, va).flatten(2)
              for (e, _), tot, (_, va) in zip(es, total, att)]
        del es
        wos = [share(view, j, prefix + "wo", 0) for j in range(m)]
        os_ = tp.reduce_scatter(pv, 2, [piece for _, piece in wos])
        parts = [o.to(dtype) @ w for o, (w, _) in zip(os_, wos)]
    else:
        for j, ((qj, _, _), (ka, va), c) in enumerate(zip(entries, att,
                                                          caches)):
            lo, hi, kmap = tp.query_heads(j, m, cfg)
            if hi == lo:
                parts.append(hs[j].new_zeros(hs[j].shape))
                continue
            klo, khi = kmap[0], kmap[-1] + 1
            kq, vq = tp.for_queries(ka[:, :, klo:khi], va[:, :, klo:khi],
                                    kmap, klo)
            mask = attn.decode_valid(c.length, 0, ka.shape[1],
                                     cfg.window)[:, None, None, None]
            o = attn.attend(qj[:, :, lo:hi], kq, vq, mask, hd)
            parts.append(o.reshape(o.shape[0], 1, (hi - lo) * hd)
                         @ view.part(j, prefix + "wo", 0, lo * hd, hi * hd))
    for c in caches:
        c.length += 1
    return parts


def _p_group_decode(view, cfg, token, caches, cache_len):
    st = tp.Stream(view.devices, 1)
    xs = tp.embed(view, cfg, st, token)
    for i in range(cfg.n_layers):
        prefix = f"blocks.{i}."
        hs = tp._norms(view, prefix + "attn_norm.", xs, cfg)
        parts = _p_decode_attention(view, prefix + "attn.", hs, caches[i],
                                    cfg, cache_len)
        xs = [x + a for x, a in zip(xs, st.reduce(parts))]
        xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
    return _p_logits(view, cfg, xs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,m,cache_len", [
    ("yi_6b", 2, S), ("yi_6b", 4, S), ("yi_6b", 2, S_WHOLE),
    ("deepseek_moe_16b", 2, S), ("granite_20b", 3, S)],
    ids=["yi-2-split", "yi-4-split", "yi-2-whole", "moe-2-split",
         "granite-3-split"])
def test_dense_and_moe_grid_steps_are_bit_equal_to_their_earlier_code(
        arch, m, cache_len, dtype):
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                              dtype=dtype)
    lm = _lm(_model(cfg), (1, m))
    prompt = torch.from_numpy(np.random.RandomState(14).randint(
        0, cfg.vocab, (B, T)).astype(np.int32))
    with torch.inference_mode():
        la, ca, _, _ = tp_serve.group_prefill(tp.GridView(lm, 0), cfg,
                                              prompt, cache_len)
        lb, cb = _p_group_prefill(tp.GridView(lm, 0), cfg, prompt,
                                  cache_len)
        outs = [(la, lb)]
        for i in range(3):
            tok = _tokens(cfg, B, 80 + i)
            outs.append((tp_serve.group_decode(tp.GridView(lm, 0), cfg, tok,
                                               ca, cache_len),
                         _p_group_decode(tp.GridView(lm, 0), cfg, tok, cb,
                                         cache_len)))
    assert all(_same(a, b) for a, b in outs)
    for layer_a, layer_b in zip(ca, cb):
        for a, b in zip(layer_a, layer_b):
            assert _same(a.k, b.k) and _same(a.v, b.v)
            assert _same(a.length, b.length)


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
families, shapes, out_path, B, T, S, n_decode = json.loads(sys.argv[1])
out = {}
for arch, over in families.items():
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                              dtype="float32", **over)
    params0 = tf.init_params(cfg, jax.random.key(0))
    rs = np.random.RandomState(5)
    if cfg.family == "audio":
        prompt = rs.randn(B, T, cfg.d_model).astype(np.float32)
    else:
        prompt = rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    img = (rs.randn(B, cfg.n_image_tokens, cfg.d_model).astype(np.float32)
           if cfg.family == "vlm" else None)
    out[arch] = {"prompt": prompt, "image_embeds": img}
    for shape in shapes:
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        rules = logical_rules(mesh)
        pshapes = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params0)
        params = jax.device_put(params0, shd.named(
            shd.param_specs(pshapes, rules, mesh), mesh))
        try:
            with logical_axis_rules(mesh, rules):
                ins = specs.input_pspecs(
                    cfg, specs.InputShape("serve", S, B, "prefill"), rules)
                args = [params, jax.device_put(jnp.asarray(prompt),
                        NamedSharding(mesh, ins["tokens"]))]
                if img is not None:
                    args.append(jax.device_put(jnp.asarray(img), NamedSharding(
                        mesh, ins["image_embeds"])))
                logits, state = jax.jit(serve.make_prefill_step(cfg, S))(
                    *args)
                got, fed = [np.asarray(logits)], []
                if cfg.family != "audio":
                    ish = specs.input_pspecs(
                        cfg, specs.InputShape("serve", S, B, "decode"), rules)
                    state = jax.device_put(state, shd.named(ish["state"],
                                                            mesh))
                    step = jax.jit(serve.make_decode_step(cfg),
                                   donate_argnums=(2,))
                    tok = serve.next_token(logits)
                    for _ in range(n_decode):
                        fed.append(np.asarray(tok))
                        logits, state = step(params, tok, state)
                        got.append(np.asarray(logits))
                        tok = serve.next_token(logits)
            res = {"logits": got, "tokens": fed}
        except Exception as e:   # filed in ROADMAP Queue 3 if it happens
            res = {"error": f"{type(e).__name__}: {e}"[:3000]}
        out[arch][str(tuple(shape))] = res
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


class ServeReference:
    """The reference's serving steps of every family on each of
    ``REF_SHAPES``, in a subprocess started at once."""

    def __init__(self, tmp_path):
        self.out = tmp_path / "serve_families.pkl"
        arg = json.dumps([FAMILIES, [list(s) for s in REF_SHAPES],
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
    job = ServeReference(tmp_path_factory.mktemp("serve_families"))
    yield job
    job.close()


@pytest.mark.parametrize("arch", list(FAMILIES))
@pytest.mark.parametrize("shape", REF_SHAPES, ids=str)
def test_grid_serving_matches_the_reference_mesh(arch, shape, serve_ref):
    ref = serve_ref.result()[arch]
    want = ref[str(shape)]
    assert "error" not in want, want.get("error")
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               dtype="float32", **FAMILIES[arch])
    p0 = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.key(0)))
    lm = fsdp.shard_reference(p0, cfg, tmesh.LogicalMesh(shape, AXES, "cpu"),
                              groups=grid(shape[1], shape[0]))
    img = (None if ref["image_embeds"] is None
           else torch.from_numpy(ref["image_embeds"]))
    logits, state = serve.make_prefill_step(cfg, S)(
        lm, torch.from_numpy(ref["prompt"]), img)
    gaps = [float(np.abs(logits.numpy() - want["logits"][0]).max())]
    step = serve.make_decode_step(cfg)
    for tok, w in zip(want["tokens"], want["logits"][1:]):
        logits, state = step(lm, torch.from_numpy(tok), state)
        gaps.append(float(np.abs(logits.numpy() - w).max()))
    n = 1 if cfg.family == "audio" else N_DECODE + 1
    assert len(gaps) == n and max(gaps) <= TOL, gaps
