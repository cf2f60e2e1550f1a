"""Port parity: the dense LM (configs, model, prefill, decode, greedy
generation) against the JAX reference.

The reference's ``transformer.init_params(cfg, jax.random.key(0))`` is loaded
into the port with ``convert.lm_params_from_jax``; the same numpy prompts go
through both. Tolerances: float32 logits and caches 2e-5 (measured <= 5e-6:
sum order of the products and of the online softmax); bfloat16 logits 3e-2
(measured <= 1.3e-2 over three archs, prefill and four decode steps, about
two bf16 ulps at |logit| ~ 1: the prefill attention keeps f32 scores and
probabilities where the reference rounds them to bf16); greedy tokens equal.
Full-size parameter counts, for all ten archs, come from shapes only (the
port's meta device, the reference's ``jax.eval_shape``).
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
from repro.data import make_lm_tokens as j_make_lm_tokens  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import make_lm_tokens  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ["yi_6b", "chatglm3_6b", "granite_20b"]
F32_TOL = 2e-5
BF16_TOL = 3e-2
CACHE_LEN = 24


def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(arch)),
                               dtype=dtype)
    params = jtf.init_params(jcfg, jax.random.key(0))
    model = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg, tcfg, params, model = _pair(request.param)
    prompts, _ = make_lm_tokens(tcfg.vocab, 2, 12, seed=3)
    return jcfg, tcfg, params, model, prompts


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def test_configs_are_the_reference_configs():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for arch in jconfigs.ARCHS:
        for get in (lambda m: m.get(arch),
                    lambda m: m.reduced(m.get(arch))):
            assert dataclasses.asdict(get(tconfigs)) == \
                dataclasses.asdict(get(jconfigs)), arch
    assert tconfigs.get("yi-6b") == tconfigs.get("yi_6b")


def test_make_lm_tokens_draws_the_reference_tokens():
    for args in ((512, 2, 12, 3), (64000, 8, 1024, 1)):
        got = make_lm_tokens(*args[:3], seed=args[3])
        want = j_make_lm_tokens(*args[:3], seed=args[3])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_prefill_logits_and_caches_match(lm):
    jcfg, tcfg, params, model, prompts = lm
    jl, js = jax.jit(jserve.make_prefill_step(jcfg, CACHE_LEN))(params,
                                                                prompts)
    tl, ts = tserve.make_prefill_step(tcfg, CACHE_LEN)(
        model, torch.from_numpy(prompts))
    assert tuple(tl.shape) == (2, 1, tcfg.vocab) == tuple(jl.shape)
    _close(jl, tl, F32_TOL)
    assert len(ts.caches) == tcfg.n_layers
    for i, cache in enumerate(ts.caches):
        _close(js.caches.k[i], cache.k, F32_TOL)
        _close(js.caches.v[i], cache.v, F32_TOL)
        np.testing.assert_array_equal(cache.length.numpy(),
                                      np.asarray(js.caches.length[i]))


def test_decode_steps_match(lm):
    jcfg, tcfg, params, model, prompts = lm
    jl, js = jax.jit(jserve.make_prefill_step(jcfg, CACHE_LEN))(params,
                                                                prompts)
    tl, ts = ttf.prefill(model, tcfg, torch.from_numpy(prompts), CACHE_LEN)
    step = jax.jit(jserve.make_decode_step(jcfg))
    for _ in range(4):
        tok = np.array(jserve.next_token(jl))
        jl, js = step(params, jnp.asarray(tok), js)
        tl, ts = ttf.decode_step(model, tcfg, torch.from_numpy(tok), ts)
        _close(jl, tl, F32_TOL)
    for i, cache in enumerate(ts.caches):
        _close(js.caches.k[i], cache.k, F32_TOL)
        assert cache.length.tolist() == [16, 16]


def test_greedy_generate_tokens_equal(lm):
    jcfg, tcfg, params, model, prompts = lm
    want = jserve.greedy_generate(params, jcfg, jnp.asarray(prompts), 6,
                                  CACHE_LEN)
    got = tserve.greedy_generate(model, tcfg, torch.from_numpy(prompts), 6,
                                 CACHE_LEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_matches_reference(lm):
    jcfg, tcfg, params, model, prompts = lm
    h = np.random.RandomState(4).randn(2, 20, tcfg.d_model).astype(np.float32)
    jh, _ = jax.jit(lambda p, x: jtf.forward(p, jcfg, x))(params,
                                                          jnp.asarray(h))
    th, aux = ttf.forward(model, tcfg, torch.from_numpy(h))
    _close(jh, th, F32_TOL)
    assert aux.item() == 0.0


def test_bfloat16_reduced_model_close_to_reference():
    jcfg, tcfg, params, model = _pair("yi_6b", "bfloat16")
    assert model.embed.dtype == torch.bfloat16
    prompts, _ = make_lm_tokens(tcfg.vocab, 2, 12, seed=3)
    jl, js = jax.jit(jserve.make_prefill_step(jcfg, CACHE_LEN))(params,
                                                                prompts)
    tl, ts = ttf.prefill(model, tcfg, torch.from_numpy(prompts), CACHE_LEN)
    assert tl.dtype == torch.bfloat16
    _close(jl, tl, BF16_TOL)
    step = jax.jit(jserve.make_decode_step(jcfg))
    for _ in range(4):
        tok = np.array(jserve.next_token(jl))
        jl, js = step(params, jnp.asarray(tok), js)
        tl, ts = ttf.decode_step(model, tcfg, torch.from_numpy(tok), ts)
        _close(jl, tl, BF16_TOL)


@pytest.mark.parametrize("arch", ["yi_6b", "yi_9b", "chatglm3_6b",
                                  "granite_20b", "deepseek_moe_16b",
                                  "llama4_scout_17b_a16e",
                                  "llama32_vision_90b", "zamba2_7b",
                                  "xlstm_125m", "hubert_xlarge"])
def test_full_size_param_count_matches_reference(arch):
    model = ttf.init_params(tconfigs.get(arch), device="meta")
    shapes = jax.eval_shape(
        lambda k: jtf.init_params(jconfigs.get(arch), k), jax.random.key(0))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes))
    assert ttf.param_count(model) == want
    if arch == "yi_6b":
        assert want == 6_061_035_520
    # the audio encoder has no embedding table
    table = model.embed if hasattr(model, "embed") else model.lm_head
    assert table.dtype == torch.bfloat16


def test_lm_params_from_jax_checks_names_and_shapes():
    jcfg = jconfigs.reduced(jconfigs.get("yi_6b"))
    tcfg = tconfigs.reduced(tconfigs.get("yi_6b"))
    tree = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda k: jtf.init_params(jcfg, k), jax.random.key(0)))
    model = convert.lm_params_from_jax(tree, tcfg)
    assert ttf.param_count(model) == sum(
        x.size for x in jax.tree_util.tree_leaves(tree))
    bad = dict(tree, blocks=dict(tree["blocks"]))
    bad["blocks"]["attn"] = dict(bad["blocks"]["attn"])
    bad["blocks"]["attn"]["wq"] = bad["blocks"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="wq has shape"):
        convert.lm_params_from_jax(bad, tcfg)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        convert.lm_params_from_jax(missing, tcfg)


def test_init_params_draws_on_the_generator_device():
    tcfg = tconfigs.reduced(tconfigs.get("chatglm3_6b"))
    a = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    b = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    assert a.embed.device.type == "cpu"
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    names = {n for n, _ in a.named_parameters()}
    assert {"embed", "lm_head", "final_norm.scale", "blocks.1.attn.wq",
            "blocks.0.mlp.wi_gate", "blocks.1.mlp_norm.scale"} <= names
    std = a.blocks[0]["attn"]["wq"].std().item()
    assert abs(std / (2.0 / (256 + 256)) ** 0.5 - 1) < 0.02
    assert abs(a.embed.std().item() / 0.02 - 1) < 0.02
