"""Port parity: every non-dense LM family (MoE, VLM cross-attention, the
hybrid Mamba2 + shared attention model, xLSTM, the audio encoder) through
``init_params`` -> ``forward`` -> ``prefill`` -> ``decode_step`` against
``repro.models.transformer``, at ``configs.reduced`` widths.

The reference's ``transformer.init_params(cfg, jax.random.key(0))`` tree is
loaded into the port with ``convert.lm_params_from_jax``; MoE expert leaves
are first redrawn per expert with numpy (the reference broadcasts one matrix
to all experts, which would hide a token sent to the wrong expert). The same
numpy prompts, image embeddings and frames go through both packages.
Tolerances: float32 logits, hidden states, caches and aux loss 2e-5
(measured <= 3e-6: sum order of the products, the online softmax and the
chunked recurrences), bfloat16 logits 3e-2 (the prefill attention keeps f32
scores and probabilities where the reference rounds them to bf16); greedy
tokens equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import make_lm_tokens  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

FAMILIES = ["deepseek_moe_16b", "llama4_scout_17b_a16e",
            "llama32_vision_90b", "zamba2_7b", "xlstm_125m", "hubert_xlarge"]
# layouts whose inner axis is longer than 1, as on the card (the VLM's
# super-blocks of 4 self + 1 cross, Zamba2's 9 x 9): the [s][j] loop order,
# the two-axis convert and one shared-block cache a call across SSM layers
DEEP = {"llama32_vision_90b.deep": ("llama32_vision_90b",
                                    dict(n_layers=6, cross_attn_every=2)),
        "zamba2_7b.deep": ("zamba2_7b", dict(n_layers=4,
                                             shared_attn_every=2))}
F32_TOL = 2e-5
BF16_TOL = 3e-2
CACHE_LEN = 24
B, T = 2, 12


def _per_expert(tree: dict, seed: int) -> dict:
    """The tree with every MoE expert leaf ``[L, E, d_in, d_out]`` redrawn
    per expert at the reference's scale (numpy f32, rounded to the leaf's
    dtype)."""
    if "blocks" not in tree or "moe" not in tree["blocks"]:
        return tree
    rs = np.random.RandomState(seed)
    moe = dict(tree["blocks"]["moe"])
    for name in ("wi_gate", "wi_up", "wo"):
        leaf = moe[name]
        d_in, d_out = leaf.shape[-2:]
        draw = rs.randn(*leaf.shape) * (2.0 / (d_in + d_out)) ** 0.5
        moe[name] = jnp.asarray(draw.astype(np.float32)).astype(leaf.dtype)
    return dict(tree, blocks=dict(tree["blocks"], moe=moe))


def _pair(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch), **over),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(arch), **over),
                               dtype=dtype)
    params = _per_expert(jtf.init_params(jcfg, jax.random.key(0)), seed=11)
    model = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _inputs(tcfg, seed=3):
    """(prompt, image embeddings or None) as numpy: int32 tokens [B, T], or
    f32 frames [B, T, d] for the audio encoder."""
    rs = np.random.RandomState(seed)
    if tcfg.family == "audio":
        prompt = rs.randn(B, T, tcfg.d_model).astype(np.float32)
    else:
        prompt = np.asarray(make_lm_tokens(tcfg.vocab, B, T, seed=seed)[0],
                            np.int32)
    img = (rs.randn(B, tcfg.n_image_tokens, tcfg.d_model).astype(np.float32)
           if tcfg.family == "vlm" else None)
    return prompt, img


@pytest.fixture(scope="module", params=FAMILIES + sorted(DEEP))
def lm(request):
    arch, over = DEEP.get(request.param, (request.param, {}))
    jcfg, tcfg, params, model = _pair(arch, **over)
    prompt, img = _inputs(tcfg)
    return jcfg, tcfg, params, model, prompt, img


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _jprefill(jcfg, params, prompt, img):
    """The reference's prefill; image embeddings in the model dtype (its
    scan carries the dtype, and a product with f32 embeddings would
    promote it)."""
    step = jax.jit(jserve.make_prefill_step(jcfg, CACHE_LEN))
    return step(params, jnp.asarray(prompt),
                None if img is None else jnp.asarray(img).astype(jcfg.dtype))


def _tprefill(tcfg, model, prompt, img):
    return tserve.make_prefill_step(tcfg, CACHE_LEN)(
        model, torch.from_numpy(prompt),
        None if img is None else torch.from_numpy(img))


def _kv(js_kv, t_cache, index, tol):
    _close(js_kv.k[index], t_cache.k, tol)
    _close(js_kv.v[index], t_cache.v, tol)
    np.testing.assert_array_equal(t_cache.length.numpy(),
                                  np.asarray(js_kv.length[index]))


def _states_close(tcfg, js, ts, tol=F32_TOL):
    """Every leaf of the port's decode state against the reference's
    stacked one."""
    if tcfg.family == "audio":
        assert js is None and ts is None
        return
    if tcfg.xlstm:
        for kind, n in (("s", 4), ("m", 3)):
            assert len(ts.caches[kind]) == js.caches[kind][0].shape[0]
            for i, layer in enumerate(ts.caches[kind]):
                assert len(layer) == n
                for j in range(n):
                    _close(js.caches[kind][j][i], layer[j], tol)
    elif tcfg.family == "vlm":
        for s, row in enumerate(ts.caches):
            for j, cache in enumerate(row):
                _kv(js.caches, cache, (s, j), tol)
            _close(js.cross_kv[0][s], ts.cross_kv[s][0], tol)
            _close(js.cross_kv[1][s], ts.cross_kv[s][1], tol)
    elif tcfg.family == "hybrid":
        jssm = js.caches["ssm"]
        for s, row in enumerate(ts.caches["ssm"]):
            for j, cache in enumerate(row):
                _close(jssm.state[s, j], cache.state, tol)
                _close(jssm.conv[s, j], cache.conv, tol)
            _kv(js.caches["attn"], ts.caches["attn"][s], s, tol)
    else:
        assert len(ts.caches) == tcfg.n_layers
        for i, cache in enumerate(ts.caches):
            _kv(js.caches, cache, i, tol)


def test_prefill_logits_and_state_match(lm):
    jcfg, tcfg, params, model, prompt, img = lm
    jl, js = _jprefill(jcfg, params, prompt, img)
    tl, ts = _tprefill(tcfg, model, prompt, img)
    assert tuple(tl.shape) == (B, 1, tcfg.vocab) == tuple(jl.shape)
    _close(jl, tl, F32_TOL)
    _states_close(tcfg, js, ts)


def test_three_decode_steps_match(lm):
    jcfg, tcfg, params, model, prompt, img = lm
    jl, js = _jprefill(jcfg, params, prompt, img)
    tl, ts = _tprefill(tcfg, model, prompt, img)
    if tcfg.family == "audio":
        tok = np.zeros((B, 1), np.int32)
        with pytest.raises(ValueError, match="decode unsupported"):
            jtf.decode_step(params, jcfg, jnp.asarray(tok),
                            jtf.init_decode_state(jcfg, B, CACHE_LEN))
        with pytest.raises(ValueError, match="decode unsupported"):
            ttf.decode_step(model, tcfg, torch.from_numpy(tok),
                            ttf.init_decode_state(tcfg, B, CACHE_LEN,
                                                  device="cpu"))
        return
    step = jax.jit(jserve.make_decode_step(jcfg))
    for _ in range(3):
        tok = np.array(jserve.next_token(jl))
        jl, js = step(params, jnp.asarray(tok), js)
        tl, ts = tserve.make_decode_step(tcfg)(model, torch.from_numpy(tok),
                                               ts)
        _close(jl, tl, F32_TOL)
    _states_close(tcfg, js, ts)


def test_greedy_tokens_equal(lm):
    """Six greedy tokens (the VLM with its image embeddings: the reference's
    ``greedy_generate`` passes none, so both loops are written out); the
    audio encoder, which has no decode step, its prefill's one."""
    jcfg, tcfg, params, model, prompt, img = lm
    n = 1 if tcfg.family == "audio" else 6
    jl, js = _jprefill(jcfg, params, prompt, img)
    tl, ts = _tprefill(tcfg, model, prompt, img)
    jstep = jax.jit(jserve.make_decode_step(jcfg))
    want, got = [], []
    for i in range(n):
        jt, tt = jserve.next_token(jl), tserve.next_token(tl)
        want.append(np.asarray(jt))
        got.append(tt.numpy())
        if i < n - 1:
            jl, js = jstep(params, jt, js)
            tl, ts = ttf.decode_step(model, tcfg, tt, ts)
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_forward_and_aux_loss_match(lm):
    """forward over embedded inputs: the final hidden and the summed MoE aux
    loss (0 for the other families). The audio encoder runs non-causal."""
    jcfg, tcfg, params, model, _, img = lm
    h = np.random.RandomState(4).randn(B, 20, tcfg.d_model).astype(
        np.float32)
    jh, jaux = jax.jit(lambda p, x, im: jtf.forward(
        p, jcfg, x, image_embeds=im))(
        params, jnp.asarray(h), None if img is None else jnp.asarray(img))
    th, taux = ttf.forward(model, tcfg, torch.from_numpy(h),
                           image_embeds=None if img is None
                           else torch.from_numpy(img))
    _close(jh, th, F32_TOL)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    _close(jaux, taux, F32_TOL)
    if tcfg.family == "moe":
        assert taux.item() > 0
    else:
        assert taux.item() == 0.0


def test_encoder_is_not_causal():
    """HuBERT (encoder_only) attends both ways: a new last frame moves the
    first position's output; the same model made causal keeps it, bit for
    bit."""
    _, tcfg, _, model = _pair("hubert_xlarge")
    rs = np.random.RandomState(5)
    h = torch.from_numpy(rs.randn(1, 8, tcfg.d_model).astype(np.float32))
    h2 = h.clone()
    h2[:, -1] = torch.from_numpy(rs.randn(tcfg.d_model).astype(np.float32))
    a, _ = ttf.forward(model, tcfg, h)
    b, _ = ttf.forward(model, tcfg, h2)
    assert (a[:, 0] - b[:, 0]).abs().max().item() > 1e-3
    causal = dataclasses.replace(tcfg, encoder_only=False)
    a, _ = ttf.forward(model, causal, h)
    b, _ = ttf.forward(model, causal, h2)
    assert torch.equal(a[:, 0], b[:, 0])


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "zamba2_7b",
                                  "llama32_vision_90b"])
def test_bfloat16_prefill_and_decode_close_to_reference(arch):
    jcfg, tcfg, params, model = _pair(arch, "bfloat16")
    prompt, img = _inputs(tcfg)
    jl, js = _jprefill(jcfg, params, prompt, img)
    tl, ts = _tprefill(tcfg, model, prompt, img)
    assert tl.dtype == torch.bfloat16
    _close(jl, tl, BF16_TOL)
    step = jax.jit(jserve.make_decode_step(jcfg))
    for _ in range(2):
        tok = np.array(jserve.next_token(jl))
        jl, js = step(params, jnp.asarray(tok), js)
        tl, ts = ttf.decode_step(model, tcfg, torch.from_numpy(tok), ts)
        _close(jl, tl, BF16_TOL)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_init_decode_state_matches_reference(arch):
    """Empty decode states: every leaf's shape and dtype, all zeros, for
    every arch (the audio encoder's is the dense layout, as in the
    reference)."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    tcfg = tconfigs.reduced(tconfigs.get(arch))
    js = jtf.init_decode_state(jcfg, 3, 16)
    ts = ttf.init_decode_state(tcfg, 3, 16, device="cpu")
    jleaves = jax.tree_util.tree_leaves(js)
    tleaves = []

    def walk(x):
        if torch.is_tensor(x):
            tleaves.append(x)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(ts)
    # the port holds per-layer entries where the reference stacks them
    assert sum(t.numel() for t in tleaves) == sum(x.size for x in jleaves)
    assert all(not t.any() for t in tleaves)
    _states_close(tcfg if tcfg.family != "audio" else
                  dataclasses.replace(tcfg, family="dense"), js, ts)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_no_family_is_refused(arch):
    """check_supported keeps only the dtype and KV-dtype checks."""
    cfg = tconfigs.get(arch)
    ttf.check_supported(cfg)
    model = ttf.init_params(cfg, device="meta")
    assert ttf.param_count(model) > 0
    for over in ({"dtype": "float16"}, {"kv_dtype": "fp8"}):
        with pytest.raises(ValueError):
            ttf.check_supported(dataclasses.replace(cfg, **over))


@pytest.mark.parametrize("case", ["llama32_vision_90b", "zamba2_7b",
                                  "xlstm_125m", "deepseek_moe_16b",
                                  "hubert_xlarge", *sorted(DEEP)])
def test_lm_params_from_jax_checks_family_trees(case):
    arch, over = DEEP.get(case, (case, {}))
    jcfg = jconfigs.reduced(jconfigs.get(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get(arch), **over)
    tree = jax.tree_util.tree_map(
        lambda s: np.arange(np.prod(s.shape), dtype=np.float32).reshape(
            s.shape) % 7,
        jax.eval_shape(lambda k: jtf.init_params(jcfg, k), jax.random.key(0)))
    model = convert.lm_params_from_jax(tree, tcfg)
    assert ttf.param_count(model) == sum(
        x.size for x in jax.tree_util.tree_leaves(tree))
    # a stacked leaf lands at its index
    stack, leaf = {"llama32_vision_90b": ("self_blocks", "attn_norm"),
                   "zamba2_7b": ("ssm_blocks", "norm"),
                   "xlstm_125m": ("mlstm", "w_if"),
                   "deepseek_moe_16b": ("blocks", "moe"),
                   "hubert_xlarge": ("blocks", "attn_norm")}[arch]
    got = dict(model.named_parameters())
    for name, arr in convert._flat_tree(tree).items():
        if name.startswith(f"{stack}.{leaf}."):
            lead = arr.shape[:2] if stack in ("self_blocks",
                                              "ssm_blocks") else arr.shape[:1]
            if over:
                assert min(lead) > 1, lead
            for index in np.ndindex(*lead):
                tail = name[len(stack) + 1:]
                port = ".".join([stack, *map(str, index), tail])
                np.testing.assert_array_equal(got[port].numpy(), arr[index])
    # a wrong shape and a missing or extra leaf are refused
    flat = convert._flat_tree(tree)
    name = next(n for n in sorted(flat) if n.startswith(stack + "."))
    bad = dict(flat, **{name: flat[name][..., :1]})
    with pytest.raises(ValueError, match="has shape"):
        convert.lm_params_from_jax(bad, tcfg)
    missing = {k: v for k, v in flat.items() if k != name}
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_jax(missing, tcfg)
    extra = dict(flat, **{"embed" if arch == "hubert_xlarge"
                          else "shared_block.norm.scale": np.zeros(3)})
    with pytest.raises(ValueError, match="unexpected"):
        convert.lm_params_from_jax(extra, tcfg)


def test_audio_prefill_takes_frames_and_has_no_state():
    jcfg, tcfg, params, model = _pair("hubert_xlarge")
    assert not hasattr(model, "embed")
    frames, _ = _inputs(tcfg, seed=6)
    jl, js = jtf.prefill(params, jcfg, jnp.asarray(frames), CACHE_LEN)
    tl, ts = ttf.prefill(model, tcfg, torch.from_numpy(frames), CACHE_LEN)
    assert js is None and ts is None
    _close(jl, tl, F32_TOL)


def test_vlm_needs_image_embeds():
    _, tcfg, _, model = _pair("llama32_vision_90b")
    prompt, _ = _inputs(tcfg)
    with pytest.raises(ValueError, match="image_embeds"):
        ttf.prefill(model, tcfg, torch.from_numpy(prompt), CACHE_LEN)
