"""Port parity: the training loss and every gradient leaf of the non-dense
LM families (MoE, VLM cross-attention, the hybrid Mamba2 + shared attention
model, xLSTM, the audio encoder) against
``jax.value_and_grad(repro.models.transformer.train_loss)``, at
``configs.reduced`` widths in f32.

The reference's ``init_params(cfg, jax.random.key(0))`` tree is loaded into
the port with ``convert.lm_params_from_jax``, MoE expert leaves first
redrawn per expert with numpy (the reference broadcasts one matrix to all
experts, which would hide a token sent to the wrong expert); the port's
gradients come back as the reference's tree through
``convert.lm_tree_to_numpy``. The same numpy tokens, frames, labels and
image embeddings go through both packages. Beside the reduced layouts: the
VLM's super-blocks of 2 self + 1 cross layers and Zamba2's 2 SSM layers a
shared block (the [s][j] loops and both checkpoint levels), a MoE at
capacity factor 0.5 (assignments dropped in every MoE layer), and
the mLSTM over several chunks (``CHUNK_M`` patched small in both
packages).

Tolerances: the loss within 2e-5 (measured <= 9.6e-7), every gradient leaf
within 1e-4 of its own max |g| (measured <= 1.6e-5, Zamba2's ``A_log``: the
SSD's f32 chunk sums in another order than XLA's); a leaf is zero in the
port exactly where it is all zero in the reference.
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
from repro.models import transformer as jtf  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402

# case -> (arch, reduced() overrides, MoE capacity factor or None)
CASES = {
    "deepseek_moe_16b": ("deepseek_moe_16b", {}, None),
    "deepseek_moe_16b.drop": ("deepseek_moe_16b", {}, 0.5),
    "llama4_scout_17b_a16e": ("llama4_scout_17b_a16e", {}, None),
    "llama32_vision_90b": ("llama32_vision_90b", {}, None),
    "llama32_vision_90b.deep": ("llama32_vision_90b",
                                dict(n_layers=6, cross_attn_every=2), None),
    "zamba2_7b": ("zamba2_7b", {}, None),
    "zamba2_7b.deep": ("zamba2_7b", dict(n_layers=4, shared_attn_every=2),
                       None),
    "xlstm_125m": ("xlstm_125m", {}, None),
    "hubert_xlarge": ("hubert_xlarge", {}, None),
}
F32_TOL = 2e-5
GRAD_REL = 1e-4
B, T = 2, 32


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


def _configs(case):
    arch, over, cap = CASES[case]
    pair = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.reduced(mod.get(arch), **over)
        if cap is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cap))
        pair.append(cfg)
    return pair


def _batch(tcfg, seed=5):
    rs = np.random.RandomState(seed)
    batch = {"labels": rs.randint(0, tcfg.vocab, (B, T)).astype(np.int32)}
    if tcfg.family == "audio":
        batch["frames"] = rs.randn(B, T, tcfg.d_model).astype(np.float32)
    else:
        batch["tokens"] = rs.randint(0, tcfg.vocab, (B, T)).astype(np.int32)
    if tcfg.family == "vlm":
        batch["image_embeds"] = rs.randn(
            B, tcfg.n_image_tokens, tcfg.d_model).astype(np.float32)
    return batch


def _leaves(tree):
    return {".".join(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _models(case):
    jcfg, tcfg = _configs(case)
    params = _per_expert(jtf.init_params(jcfg, jax.random.key(0)), seed=11)
    model = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _check(case):
    jcfg, tcfg, params, model = _models(case)
    batch = _batch(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.train_loss(p, jcfg, b)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = ttrain.value_and_grad(
        model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(tl.item())
    assert abs(tl.item() - float(jl)) <= F32_TOL, (tl.item(), float(jl))
    want = _leaves(jg)
    got = _leaves(convert.lm_tree_to_numpy(tg, tcfg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_REL * scale, (
            f"{case} {name}: max abs err {err:.3e} > {GRAD_REL} x "
            f"{scale:.3e}")
        assert np.any(got[name]) == np.any(w), f"{case} {name}: all zero"
    return jcfg, tcfg, got


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if not c.startswith("xlstm")))
def test_train_loss_and_gradients_match_reference(case):
    _, tcfg, got = _check(case)
    if tcfg.family == "moe":
        # every routed expert leaf is reached (experts drawn per expert)
        assert np.all(np.abs(got["blocks.moe.wo"]).max(axis=(2, 3)) > 0)


@pytest.mark.parametrize("chunk_m", [None, 8])
def test_xlstm_train_loss_and_gradients_match_reference(chunk_m,
                                                        monkeypatch):
    if chunk_m is not None:         # the mLSTM over T / 8 chunks
        monkeypatch.setattr(jxlstm, "CHUNK_M", chunk_m)
        monkeypatch.setattr(txlstm, "CHUNK_M", chunk_m)
    _check("xlstm_125m")


def test_the_drop_case_drops_assignments(monkeypatch):
    """The precondition of ``deepseek_moe_16b.drop``: the training forward
    sends some assignment to the overflow slot."""
    from repro_torch.models import moe as tmoe

    _, tcfg, _, model = _models("deepseek_moe_16b.drop")
    dispatch, dropped = tmoe._dispatch, []

    def record(x, eidx, e, k, cap):
        buf, slot, order = dispatch(x, eidx, e, k, cap)
        dropped.append(int((slot == e * cap).sum()))
        return buf, slot, order

    monkeypatch.setattr(tmoe, "_dispatch", record)
    batch = _batch(tcfg)
    ttrain.value_and_grad(
        model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert dropped and all(n > 0 for n in dropped), dropped
