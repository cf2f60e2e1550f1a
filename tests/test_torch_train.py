"""Port parity: LM training (``attend_chunked``, ``chunked_ce_loss``,
``train_loss``, the dense train step) against the JAX reference, and the
inverse tree converter.

The reference's ``transformer.init_params(cfg, jax.random.key(0))`` is
loaded into the port with ``convert.lm_params_from_jax``; the same numpy
batches go through ``jax.value_and_grad(train_loss)`` and the port's
``launch.train.value_and_grad``; the port's gradients come back as the
reference's tree through ``convert.lm_tree_to_numpy``.

Tolerances:
* ``attend_chunked`` and ``chunked_ce_loss``, f32: outputs and gradients
  within 2e-5 (measured <= 1.9e-6: sum order of the products, the
  softmax and the logsumexp);
* ``train_loss`` in f32: the loss within 2e-5 (measured <= 4.8e-7), every
  gradient leaf within 1e-4 of its own max |g| (measured <= 2.3e-6);
* in bf16: the loss within 2e-3 (measured <= 3.8e-4), every gradient leaf
  within 5e-2 of its own max |g| (measured <= 1.6e-2: every product and
  the residual stream round to bf16, in another order than XLA's);
* one SGD step (lr 0.01) at ``n_micro`` 1 and 2, f32: the loss within
  2e-5, the parameters within 1e-6 (measured <= 1.5e-8).
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
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ["yi_6b", "chatglm3_6b", "granite_20b"]
F32_TOL = 2e-5
F32_GRAD_REL = 1e-4
BF16_LOSS_TOL = 2e-3
BF16_GRAD_REL = 5e-2
STEP_PARAM_TOL = 1e-6
B, T = 2, 32


def _pair(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch), **over),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(arch), **over),
                               dtype=dtype)
    params = jtf.init_params(jcfg, jax.random.key(0))
    model = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _batch(tcfg, b=B, t=T, seed=5):
    """Numpy tokens (or frames), labels and, for the VLM, image
    embeddings."""
    rs = np.random.RandomState(seed)
    batch = {"labels": rs.randint(0, tcfg.vocab, (b, t)).astype(np.int32)}
    if tcfg.family == "audio":
        batch["frames"] = rs.randn(b, t, tcfg.d_model).astype(np.float32)
    else:
        batch["tokens"] = rs.randint(0, tcfg.vocab, (b, t)).astype(np.int32)
    if tcfg.family == "vlm":
        batch["image_embeds"] = rs.randn(
            b, tcfg.n_image_tokens, tcfg.d_model).astype(np.float32)
    return batch


def _jgrad(jcfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtf.train_loss(p, jcfg, b)))(params, jb)


def _leaves(tree):
    """{"blocks.attn.wq": array} of a nested tree."""
    return {".".join(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads_close(jgrads, tgrads, tcfg, rel):
    """Every leaf of the port's gradients (as the reference's tree) within
    ``rel`` of the leaf's max |g|; the names and shapes equal."""
    want = _leaves(jgrads)
    got = _leaves(convert.lm_tree_to_numpy(tgrads, tcfg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name] - w).max())
        assert err <= rel * scale, (
            f"{name}: max abs err {err:.3e} > {rel} x {scale:.3e}")


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# ------------------------------------------------------------- attention
ATTEND_CASES = {
    "short_causal": dict(t=12, chunk=None, causal=True, window=None),
    "short_window": dict(t=12, chunk=None, causal=True, window=5),
    "chunked_causal": dict(t=32, chunk=8, causal=True, window=None),
    "chunked_window": dict(t=32, chunk=8, causal=True, window=11),
    "chunked_noncausal": dict(t=32, chunk=8, causal=False, window=None),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_attend_chunked_matches_reference(case, monkeypatch):
    c = ATTEND_CASES[case]
    if c["chunk"] is not None:
        monkeypatch.setattr(jattn, "CHUNK_Q", c["chunk"])
        monkeypatch.setattr(tattn, "CHUNK_Q", c["chunk"])
    rs = np.random.RandomState(1)
    b, t, h, kv, hd = 2, c["t"], 4, 2, 16
    q, k, v = (rs.randn(b, t, n, hd).astype(np.float32)
               for n in (h, kv, kv))
    ct = rs.randn(b, t, h, hd).astype(np.float32)
    kw = dict(hd=hd, causal=c["causal"], window=c["window"])

    out, vjp = jax.vjp(lambda *a: jattn.attend_chunked(*a, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tattn.attend_chunked(tq, tk, tv, **kw)
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=F32_TOL, atol=F32_TOL)
    for name, g, w in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"d{name}")


def _direct(fn, *args, use_reentrant=None):
    """``checkpoint`` that saves every activation: the function called."""
    return fn(*args)


def test_attend_chunked_remat_is_bit_equal(monkeypatch):
    monkeypatch.setattr(tattn, "CHUNK_Q", 8)
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(2, 32, n, 16).astype(np.float32))
               .requires_grad_(True) for n in (4, 2, 2))
    runs = []
    for remat in (True, False):
        if not remat:
            monkeypatch.setattr(tattn, "checkpoint", _direct)
        out = tattn.attend_chunked(q, k, v, hd=16, causal=True, window=9)
        runs.append((out,) + torch.autograd.grad(out.square().sum(),
                                                 (q, k, v)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_attend_chunked_refuses_a_ragged_length(monkeypatch):
    monkeypatch.setattr(tattn, "CHUNK_Q", 8)
    q = torch.zeros(1, 12, 2, 8)
    with pytest.raises(ValueError, match="CHUNK_Q"):
        tattn.attend_chunked(q, q, q, hd=8, causal=True, window=None)


# ------------------------------------------------------------- CE loss
def test_chunked_ce_loss_drops_the_tail_like_the_reference():
    rs = np.random.RandomState(3)
    t, d, vocab, chunk = 32, 16, 40, 12      # 2 chunks, a tail of 8
    h = rs.randn(B, t, d).astype(np.float32)
    w = rs.randn(d, vocab).astype(np.float32)
    labels = rs.randint(0, vocab, (B, t)).astype(np.int32)
    loss, (gh, gw) = jax.value_and_grad(
        lambda a, b: jtf.chunked_ce_loss(a, b, jnp.asarray(labels), chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = ttf.chunked_ce_loss(th, tw, torch.from_numpy(labels), chunk)
    tgh, tgw = torch.autograd.grad(got, (th, tw))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(got.item() - float(loss)) <= F32_TOL
    np.testing.assert_allclose(tgh.numpy(), np.asarray(gh), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(gw), rtol=F32_TOL,
                               atol=F32_TOL)
    # the tail's positions get no gradient, whatever their labels
    assert torch.count_nonzero(tgh[:, 24:]) == 0
    other = labels.copy()
    other[:, 24:] = (other[:, 24:] + 1) % vocab
    same = ttf.chunked_ce_loss(th, tw, torch.from_numpy(other), chunk)
    assert same.item() == got.item()


# ---------------------------------------------------------- train loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(arch, dtype):
    jcfg, tcfg, params, model = _pair(arch, dtype)
    batch = _batch(tcfg)
    jl, jg = _jgrad(jcfg, params, batch)
    tl, tg = ttrain.value_and_grad(model, tcfg, _tbatch(batch))
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert all(tg[n].dtype == p.dtype for n, p in model.named_parameters())
    loss_tol, rel = ((F32_TOL, F32_GRAD_REL) if dtype == "float32"
                     else (BF16_LOSS_TOL, BF16_GRAD_REL))
    assert abs(tl.item() - float(jl)) <= loss_tol, (tl.item(), float(jl))
    _grads_close(jg, tg, tcfg, rel)
    # serving still sees frozen parameters
    assert not any(p.requires_grad for p in model.parameters())


def test_train_loss_over_two_attention_chunks(monkeypatch):
    """T = 2 x CHUNK_Q (patched small in both packages): the chunked
    attention path of a whole model, with a sliding window of 12."""
    monkeypatch.setattr(jattn, "CHUNK_Q", 16)
    monkeypatch.setattr(tattn, "CHUNK_Q", 16)
    jcfg, tcfg, params, model = _pair("yi_6b", window=12)
    batch = _batch(tcfg)
    jl, jg = _jgrad(jcfg, params, batch)
    tl, tg = ttrain.value_and_grad(model, tcfg, _tbatch(batch))
    assert abs(tl.item() - float(jl)) <= F32_TOL
    _grads_close(jg, tg, tcfg, F32_GRAD_REL)


def test_remat_is_numerics_neutral(monkeypatch):
    monkeypatch.setattr(tattn, "CHUNK_Q", 16)
    _, tcfg, _, model = _pair("yi_6b")
    batch = _tbatch(_batch(tcfg))
    la, ga = ttrain.value_and_grad(model, tcfg, batch)
    monkeypatch.setattr(tattn, "checkpoint", _direct)
    monkeypatch.setattr(ttf, "checkpoint", _direct)
    lb, gb = ttrain.value_and_grad(model, tcfg, batch)
    assert la.item() == lb.item()
    for n in ga:
        assert torch.equal(_bits(ga[n]), _bits(gb[n])), n


def test_two_gradients_from_one_state_are_bit_equal():
    _, tcfg, _, model = _pair("granite_20b", "bfloat16")
    batch = _tbatch(_batch(tcfg))
    la, ga = ttrain.value_and_grad(model, tcfg, batch)
    lb, gb = ttrain.value_and_grad(model, tcfg, batch)
    assert la.item() == lb.item()
    for n in ga:
        assert torch.equal(_bits(ga[n]), _bits(gb[n])), n


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("n_micro", [1, 2])
def test_dense_train_step_matches_reference(n_micro):
    jcfg, tcfg, params, model = _pair("yi_6b")
    batch = _batch(tcfg, b=4)
    jstep = jax.jit(jtrain.make_dense_train_step(jcfg, lr=0.01,
                                                 n_micro=n_micro))
    jnew, jl = jstep(params, {k: jnp.asarray(v) for k, v in batch.items()})
    step = ttrain.make_dense_train_step(tcfg, lr=0.01, n_micro=n_micro)
    out, tl = step(model, _tbatch(batch))
    assert out is model and tl.dtype == torch.float32
    assert abs(tl.item() - float(jl)) <= F32_TOL
    want = _leaves(jnew)
    got = _leaves(convert.lm_tree_to_numpy(model, tcfg))
    old = _leaves(params)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=STEP_PARAM_TOL, err_msg=name)
        # the step moved every leaf
        assert not np.array_equal(got[name], old[name]), name


def test_two_microbatches_equal_one_batch_up_to_rounding():
    _, tcfg, _, model = _pair("chatglm3_6b")
    batch = _tbatch(_batch(tcfg, b=4))
    one = ttf.init_params(tcfg, device="cpu")
    one.load_state_dict(model.state_dict())
    _, l1 = ttrain.make_dense_train_step(tcfg, n_micro=1)(one, batch)
    _, l2 = ttrain.make_dense_train_step(tcfg, n_micro=2)(model, batch)
    assert abs(l1.item() - l2.item()) <= F32_TOL
    for (n, a), b in zip(one.named_parameters(), model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=STEP_PARAM_TOL,
                                   msg=n)


@pytest.mark.parametrize("n_params,want", [
    (125e6, 1), (4e9, 1), (6_061_035_520, 2), (12e9, 2), (20e9, 4),
    (50e9, 4), (90e9, 8)])
def test_micro_batches_follows_the_dryrun_rule(n_params, want):
    # the reference's inline rule (repro/launch/dryrun.py)
    ref = (8 if n_params > 50e9 else (4 if n_params > 12e9 else
                                      (2 if n_params > 4e9 else 1)))
    assert ttrain.micro_batches(int(n_params)) == want == ref


# ------------------------------------------------------- tree converter
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_lm_tree_to_numpy_round_trips(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get(arch)),
                               dtype=dtype)
    model = ttf.init_params(tcfg, torch.Generator().manual_seed(4))
    tree = convert.lm_tree_to_numpy(model, tcfg)
    back = convert.lm_params_from_jax(tree, tcfg)
    for (n, a), b in zip(model.named_parameters(), back.parameters()):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), n
    # the reference's own tree: the same names, nesting and stacked shapes
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.random.key(0))
    want = jax.tree_util.tree_map(lambda s: s.shape, shapes)
    assert jax.tree_util.tree_map(np.shape, tree) == want
    # a gradient mapping converts as the module does
    named = {n: p.detach() for n, p in model.named_parameters()}
    again = convert.lm_tree_to_numpy(named, tcfg)
    for name, leaf in _leaves(tree).items():
        assert np.array_equal(_leaves(again)[name], leaf)


def test_lm_tree_to_numpy_refuses_a_partial_stack():
    tcfg = tconfigs.reduced(tconfigs.get("yi_6b"))
    model = ttf.init_params(tcfg, device="cpu")
    named = {n: p for n, p in model.named_parameters()
             if not n.startswith("blocks.0.")}
    with pytest.raises(ValueError, match="blocks"):
        convert.lm_tree_to_numpy(named, tcfg)


def test_floor_at_splits_a_tie_like_jnp_maximum():
    """The sLSTM's and mLSTM's denominators and the MoE gate sum use
    ``floor_at``: ``clamp_min``'s values with ``jnp.maximum``'s gradient,
    half of it to each side at a tie."""
    from repro_torch.models.layers import floor_at

    x = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.maximum(a, 1.0) * a))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((floor_at(tx, 1.0) * tx).sum(), tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].item() == 1.5           # 1 from the product, 1/2 the tie
    assert torch.equal(floor_at(tx, 1.0), tx.detach().clamp_min(1.0))


# ------------------------------------------------------ flash stays out
def test_flash_attention_refuses_inputs_that_require_grad():
    rs = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rs.randn(1, 8, n, 16).astype(np.float32))
               for n in (2, 1, 1))
    plain = ops.flash_attention(q, k, v)
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(*args)
        with torch.no_grad():       # grad mode off: a forward call
            assert torch.equal(ops.flash_attention(*args), plain)


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_train_loss_never_reaches_flash(arch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("training reached ops.flash_attention")

    _, tcfg, _, model = _pair(arch)
    batch = _tbatch(_batch(tcfg, t=16))
    monkeypatch.setattr(ops, "flash_attention", refuse)
    loss, grads = ttrain.value_and_grad(model, tcfg, batch)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    if tcfg.xlstm:
        return
    # serving still goes through the flash kernel's entry point
    h = (batch["frames"] if tcfg.family == "audio"
         else ttf.embed_tokens(model, tcfg, batch["tokens"]))
    with pytest.raises(AssertionError, match="reached"):
        ttf.forward(model, tcfg, h, image_embeds=batch.get("image_embeds"))
