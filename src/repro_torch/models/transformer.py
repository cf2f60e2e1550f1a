"""The architecture-generic LM: parameters, forward, prefill and one-token
decode for every family of the reference (port of
``repro.models.transformer``): dense, MoE, VLM cross-attention, the audio
encoder, the hybrid Mamba2 + shared attention model and xLSTM.

The parameters mirror the reference's tree, leaf for leaf:

* ``embed`` [V, d] (absent for the audio encoder, which takes frame
  embeddings), ``lm_head`` [d, V] (absent when embeddings are tied),
  ``final_norm``;
* dense, MoE, audio: ``blocks[i]`` = ``{attn_norm, attn: {wq, wk, wv, wo},
  mlp_norm, mlp | moe}``;
* VLM: ``self_blocks[s][j]`` and ``cross_blocks[s]``, super-blocks of
  ``cross_attn_every`` self-attention layers and one cross-attention layer;
* hybrid: ``ssm_blocks[s][j]`` = ``{norm, ssm}`` and ONE ``shared_block``,
  called after every ``shared_attn_every`` SSM layers with its own KV cache
  at each call;
* xLSTM: ``slstm[i]`` and ``mlstm[i]``, alternating (sLSTM at even layers).

The reference stacks the blocks on leading axes and scans over them; the
port holds ``nn.ModuleList``s and loops. Every prefill self- and
cross-attention runs through the flash kernel (``models/attention.py``).
Serving runs under ``torch.inference_mode()``.

Training (``train_loss``; ``forward(..., train=True)``) runs under autograd
with the reference's remat: every block (dense, MoE, audio), every VLM self
block and super-block and every hybrid SSM block and super-block under a
non-reentrant ``checkpoint``, attention through ``attend_chunked``, and the
cross-entropy per 128-token chunk (``chunked_ce_loss``). The xLSTM stack is
unrolled without a checkpoint, as in the reference. Parameters are created
with ``requires_grad=False`` (serving); ``launch.train.value_and_grad``
turns it on for the gradient it takes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       embed_lookup, init_mlp, init_norm)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a dtype or KV dtype the port has no path
    for."""
    if cfg.dtype not in DTYPES:
        raise ValueError(f"{cfg.name}: dtype {cfg.dtype!r} not in "
                         f"{sorted(DTYPES)}")
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"{cfg.name}: kv_dtype {cfg.kv_dtype!r} not in "
                         "('bf16', 'int8')")


def n_super(cfg: ArchConfig) -> int:
    """Super-blocks of the VLM (``cross_attn_every`` + 1 layers) or the
    hybrid (``shared_attn_every`` SSM layers)."""
    if cfg.family == "vlm":
        return cfg.n_layers // (cfg.cross_attn_every + 1)
    return cfg.n_layers // cfg.shared_attn_every


# ------------------------------------------------------------------ block init
def _init_self_block(g, cfg: ArchConfig, dtype, device) -> nn.ModuleDict:
    p = {
        "attn_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn.init_attention(g, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, dtype, device),
        "mlp_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
    }
    if cfg.family == "moe" and cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(g, cfg.d_model, cfg.moe, cfg.act, dtype,
                                    device)
    else:
        p["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, cfg.act, dtype, device)
    return nn.ModuleDict(p)


def _init_cross_block(g, cfg: ArchConfig, dtype, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "attn_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn.init_attention(g, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, dtype, device),
        "mlp_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "mlp": init_mlp(g, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
    })


def _init_ssm_block(g, cfg: ArchConfig, dtype, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
        "ssm": ssm_mod.init_ssm(g, cfg.d_model, cfg.ssm, dtype, device),
    })


class TransformerLM(nn.Module):
    """An LM's parameters in the reference's layout (module docstring)."""

    def __init__(self, cfg: ArchConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device="cuda"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        g = generator
        if cfg.family != "audio":
            self.embed = embed_init(g, cfg.vocab, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            # the reference draws [V, d] and transposes it
            self.lm_head = nn.Parameter(
                embed_init(g, cfg.vocab, cfg.d_model, dtype, device).T
                .contiguous(), requires_grad=False)
        self.final_norm = init_norm(cfg.d_model, cfg.norm, dtype, device)

        def stack(n, make):
            return nn.ModuleList(make() for _ in range(n))

        if cfg.xlstm:
            self.slstm = stack((cfg.n_layers + 1) // 2, lambda: (
                xlstm_mod.init_slstm(g, cfg.d_model, cfg.n_heads, dtype,
                                     device)))
            self.mlstm = stack(cfg.n_layers // 2, lambda: (
                xlstm_mod.init_mlstm(g, cfg.d_model, cfg.n_heads, dtype,
                                     device)))
        elif cfg.family == "vlm":
            self.self_blocks = stack(n_super(cfg), lambda: stack(
                cfg.cross_attn_every,
                lambda: _init_self_block(g, cfg, dtype, device)))
            self.cross_blocks = stack(n_super(cfg), lambda: (
                _init_cross_block(g, cfg, dtype, device)))
        elif cfg.family == "hybrid":
            self.ssm_blocks = stack(n_super(cfg), lambda: stack(
                cfg.shared_attn_every,
                lambda: _init_ssm_block(g, cfg, dtype, device)))
            self.shared_block = _init_self_block(g, cfg, dtype, device)
        else:  # dense / moe / audio: a uniform stack
            self.blocks = stack(cfg.n_layers, lambda: (
                _init_self_block(g, cfg, dtype, device)))


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> TransformerLM:
    """The model with weights drawn from ``generator`` at the reference's
    scales, on ``device`` (default: the generator's, else CUDA). On the
    meta device nothing is drawn: shapes only."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    return TransformerLM(cfg, generator, device=device)


def lm_head_weight(params: TransformerLM, cfg: ArchConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def embed_tokens(params: TransformerLM, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings; the gradient folds repeated tokens' rows in token
    order (``layers.embed_lookup``), so it is the same on every run."""
    return embed_lookup(params.embed, tokens)


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def _image_embeds(cfg: ArchConfig, image_embeds, like: torch.Tensor):
    """The VLM's image embeddings in the model dtype (the flash kernel takes
    one dtype; the reference promotes a product of mixed dtypes instead)."""
    if image_embeds is None:
        raise ValueError(f"{cfg.name}: the VLM family needs image_embeds")
    return image_embeds.to(device=like.device, dtype=like.dtype)


# ------------------------------------------------------------- block forwards
def _mlp_or_moe(p: nn.ModuleDict, cfg: ArchConfig, h: torch.Tensor):
    """The block's MLP or MoE on normed h: (out, aux loss)."""
    if "moe" in p:
        out = moe_mod.apply_moe(p["moe"], h, cfg.moe)
        return out.y, out.aux_loss
    return apply_mlp(p["mlp"], h, cfg.act), None


def _self_block(p: nn.ModuleDict, cfg: ArchConfig, x: torch.Tensor, *,
                causal: bool, window: Optional[int], train: bool = False):
    """Pre-norm attention + MLP/MoE. Returns (x, aux_loss or None)."""
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    x = x + attn.self_attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope=cfg.rope, causal=causal, window=window, train=train)
    y, aux = _mlp_or_moe(p, cfg, apply_norm(p["mlp_norm"], x, cfg.norm))
    return x + y, aux


def _cross_block(p: nn.ModuleDict, cfg: ArchConfig, x: torch.Tensor,
                 kv_src: torch.Tensor, kv: Optional[tuple] = None,
                 train: bool = False):
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    x = x + attn.cross_attention(p["attn"], h, kv_src, n_heads=cfg.n_heads,
                                 n_kv=cfg.n_kv_heads, hd=cfg.hd, kv=kv,
                                 train=train)
    h = apply_norm(p["mlp_norm"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], h, cfg.act)


def _ssm_block(p: nn.ModuleDict, cfg: ArchConfig, x: torch.Tensor):
    y, _ = ssm_mod.ssd_forward(p["ssm"], apply_norm(p["norm"], x, cfg.norm),
                               cfg.ssm)
    return x + y


def _xlstm_layer(params: TransformerLM, i: int):
    """Layer i of the xLSTM stack: (is sLSTM, its parameters)."""
    return (i % 2 == 0,
            (params.slstm if i % 2 == 0 else params.mlstm)[i // 2])


def _full(p):
    """A block's parameters as the block functions read them: ``p`` itself,
    or, for a group of sharded parameters (``launch/fsdp.py``), its tensors
    gathered whole on the group's device. Called inside the block's
    checkpointed function, so the backward's recompute gathers again."""
    gather = getattr(p, "gather", None)
    return gather() if callable(gather) else p


# --------------------------------------------------------------- full forward
def forward(params: TransformerLM, cfg: ArchConfig, h: torch.Tensor, *,
            window: Optional[int] = None,
            image_embeds: Optional[torch.Tensor] = None,
            train: bool = False):
    """Full-stack forward of an embedded input h [B,T,d]. Returns
    (final-normed hidden, total MoE aux loss, f32). ``encoder_only``
    configurations attend without the causal mask.

    Serving (the default) runs under ``torch.inference_mode()`` with the
    flash kernel. ``train=True`` runs under autograd, attention through
    ``attend_chunked``, each block under a non-reentrant ``checkpoint``
    where the reference remats a scan body. ``params`` may also be one
    group's view of sharded parameters (``launch.fsdp.GroupView``): each
    block is then gathered inside its checkpoint (xLSTM's layers, which
    have none, as they run)."""
    with torch.inference_mode(not train):
        causal = not cfg.encoder_only
        window = window if window is not None else cfg.window

        def ckpt(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if train \
                else fn(*args)

        def self_block(bp, x, aux):
            x, a = _self_block(_full(bp), cfg, x, causal=causal,
                               window=window, train=train)
            return x, aux if a is None else aux + a

        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.xlstm:
            for i in range(cfg.n_layers):
                is_s, p = _xlstm_layer(params, i)
                run = (xlstm_mod.slstm_forward if is_s
                       else xlstm_mod.mlstm_forward)
                h = h + run(_full(p), h, cfg.n_heads)[0]
        elif cfg.family == "vlm":
            img = _image_embeds(cfg, image_embeds, h)

            def vlm_super(x, aux, self_ps, cross_p):
                for bp in self_ps:
                    x, aux = ckpt(self_block, bp, x, aux)
                return _cross_block(_full(cross_p), cfg, x, img,
                                    train=train), aux

            for self_ps, cross_p in zip(params.self_blocks,
                                        params.cross_blocks):
                h, aux = ckpt(vlm_super, h, aux, self_ps, cross_p)
        elif cfg.family == "hybrid":
            def ssm_block(bp, x):
                return _ssm_block(_full(bp), cfg, x)

            def hybrid_super(x, aux, ssm_ps):
                for bp in ssm_ps:
                    x = ckpt(ssm_block, bp, x)
                return self_block(params.shared_block, x, aux)

            for ssm_ps in params.ssm_blocks:
                h, aux = ckpt(hybrid_super, h, aux, ssm_ps)
        else:
            for bp in params.blocks:
                h, aux = ckpt(self_block, bp, h, aux)
        return apply_norm(_full(params.final_norm), h, cfg.norm), aux


# ----------------------------------------------------------------------- loss
def chunked_ce_loss(h: torch.Tensor, w_head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Next-token cross-entropy without the full [B, T, V] logits: per
    chunk of ``min(chunk, T)`` positions (a ``T % chunk`` tail is dropped,
    as in the reference), logits ``hx @ w_head`` in the model dtype, then
    f32, ``logsumexp - gold`` averaged over the chunk; the mean over
    chunks. Each chunk under a non-reentrant ``checkpoint``: the backward
    recomputes its logits."""
    t = h.shape[1]
    chunk = min(chunk, t)

    def per_chunk(hx, lx):
        logits = (hx @ w_head).float()
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, lx[..., None])[..., 0]
        return torch.mean(lse - gold)

    losses = [checkpoint(per_chunk, h[:, s:s + chunk],
                         labels[:, s:s + chunk].long(), use_reentrant=False)
              for s in range(0, t // chunk * chunk, chunk)]
    return torch.mean(torch.stack(losses))


def train_loss(params: TransformerLM, cfg: ArchConfig,
               batch: dict) -> torch.Tensor:
    """The training loss, f32: ``batch`` holds ``tokens`` (or ``frames``
    [B, T, d] for the audio encoder), ``labels`` and, for the VLM,
    ``image_embeds``. Chunked cross-entropy of the full-stack forward plus
    the MoE aux loss, under autograd (``forward(..., train=True)``)."""
    if cfg.family == "audio":
        h = batch["frames"].to(DTYPES[cfg.dtype])
    else:
        h = embed_tokens(params, cfg, batch["tokens"])
    h, aux = forward(params, cfg, h, image_embeds=batch.get("image_embeds"),
                     train=True)
    ce = chunked_ce_loss(h, lm_head_weight(params, cfg), batch["labels"])
    return ce + aux


# ------------------------------------------------------------------- serving
@dataclasses.dataclass
class DecodeState:
    """A family's decode caches, written in place by ``decode_step``:

    * dense, MoE (and audio, which has no decode): one ``KVCache`` a layer;
    * VLM: ``caches[s][j]`` a ``KVCache`` per self-attention layer;
      ``cross_kv[s]`` the (k, v) projected from the image embeddings;
    * hybrid: ``{"ssm": [[SSMCache]], "attn": [KVCache]}``, one attention
      cache per call of the shared block;
    * xLSTM: ``{"s": [(c, n, m, h)], "m": [(C, n, m)]}``.
    """
    caches: object
    cross_kv: Optional[list] = None


def _kv_cache(cfg: ArchConfig, batch: int, cache_len: int,
              device) -> KVCache:
    kv_dt = torch.int8 if cfg.kv_dtype == "int8" else DTYPES[cfg.dtype]
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=kv_dt, device=device),
                   v=torch.zeros(shape, dtype=kv_dt, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda") -> DecodeState:
    """Empty caches (length 0) for ``batch`` rows of ``cache_len`` slots,
    int8 K/V when ``cfg.kv_dtype == 'int8'``; recurrent states at zero."""
    check_supported(cfg)
    dtype = DTYPES[cfg.dtype]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if cfg.xlstm:
        _, dh = xlstm_mod._cell_dims(cfg.d_model, cfg.n_heads)
        h = cfg.n_heads
        return DecodeState(caches={
            "s": [tuple(zeros(batch, h, dh) for _ in range(4))
                  for _ in range((cfg.n_layers + 1) // 2)],
            "m": [(zeros(batch, h, dh, dh), zeros(batch, h, dh),
                   zeros(batch, h)) for _ in range(cfg.n_layers // 2)]})
    if cfg.family == "vlm":
        img = (batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd)
        return DecodeState(
            caches=[[_kv_cache(cfg, batch, cache_len, device)
                     for _ in range(cfg.cross_attn_every)]
                    for _ in range(n_super(cfg))],
            cross_kv=[tuple(torch.zeros(img, dtype=dtype, device=device)
                            for _ in range(2)) for _ in range(n_super(cfg))])
    if cfg.family == "hybrid":
        return DecodeState(caches={
            "ssm": [[ssm_mod.init_cache(batch, cfg.d_model, cfg.ssm, dtype,
                                        device)
                     for _ in range(cfg.shared_attn_every)]
                    for _ in range(n_super(cfg))],
            "attn": [_kv_cache(cfg, batch, cache_len, device)
                     for _ in range(n_super(cfg))]})
    return DecodeState(caches=[_kv_cache(cfg, batch, cache_len, device)
                               for _ in range(cfg.n_layers)])


def _conv_tail(hn: torch.Tensor, p_ssm, cfg: ArchConfig) -> torch.Tensor:
    """The last (d_conv - 1) pre-conv xBC inputs: the rolling context that
    ``ssm.ssd_decode_step``'s causal conv expects."""
    spec = cfg.ssm
    d_inner = spec.expand * cfg.d_model
    gn = spec.n_groups * spec.d_state
    tail = hn[:, -(spec.d_conv - 1):, :] @ p_ssm["in_proj"]
    return tail[..., d_inner: 2 * d_inner + 2 * gn]


@torch.inference_mode()
def prefill(params: TransformerLM, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int, image_embeds: Optional[torch.Tensor] = None):
    """Prompt int[B, T] -> (last-position logits [B, 1, V], DecodeState).

    Attention families fill their KV caches to T, recurrent ones return
    their final states, the VLM caches the image K/V; the audio encoder has
    no decode phase: ``tokens`` are frame embeddings [B, T, d], its prefill
    is the full encode and the state is None."""
    if cfg.family == "audio":
        h, _ = forward(params, cfg, tokens.to(DTYPES[cfg.dtype]))
        return h[:, -1:] @ lm_head_weight(params, cfg), None

    h = embed_tokens(params, cfg, tokens)
    window = cfg.window

    if cfg.xlstm:
        new_s, new_m = [], []
        for i in range(cfg.n_layers):
            is_s, p = _xlstm_layer(params, i)
            if is_s:
                y, carry = xlstm_mod.slstm_forward(p, h, cfg.n_heads)
                new_s.append(carry)
            else:
                y, carry = xlstm_mod.mlstm_forward(p, h, cfg.n_heads)
                new_m.append(carry)
            h = h + y
        h = apply_norm(params.final_norm, h[:, -1:], cfg.norm)
        return h @ lm_head_weight(params, cfg), DecodeState(
            caches={"s": new_s, "m": new_m})

    def self_prefill(bp, x):
        hn = apply_norm(bp["attn_norm"], x, cfg.norm)
        a, cache = attn.prefill_cache(
            bp["attn"], hn, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, rope=cfg.rope, window=window, cache_len=cache_len)
        x = x + a
        y, _ = _mlp_or_moe(bp, cfg, apply_norm(bp["mlp_norm"], x, cfg.norm))
        return x + y, cache

    if cfg.family == "vlm":
        img = _image_embeds(cfg, image_embeds, h)
        caches, cross = [], []
        for self_ps, cross_p in zip(params.self_blocks, params.cross_blocks):
            row = []
            for bp in self_ps:
                h, cache = self_prefill(bp, h)
                row.append(cache)
            kv = attn.cross_kv(cross_p["attn"], img, n_kv=cfg.n_kv_heads,
                               hd=cfg.hd)
            h = _cross_block(cross_p, cfg, h, img, kv=kv)
            caches.append(row)
            cross.append(kv)
        state = DecodeState(caches=caches, cross_kv=cross)
    elif cfg.family == "hybrid":
        ssm_caches, attn_caches = [], []
        for ssm_ps in params.ssm_blocks:
            row = []
            for bp in ssm_ps:
                hn = apply_norm(bp["norm"], h, cfg.norm)
                y, s_final = ssm_mod.ssd_forward(bp["ssm"], hn, cfg.ssm)
                row.append(ssm_mod.SSMCache(
                    state=s_final, conv=_conv_tail(hn, bp["ssm"], cfg)))
                h = h + y
            h, cache = self_prefill(params.shared_block, h)
            ssm_caches.append(row)
            attn_caches.append(cache)
        state = DecodeState(caches={"ssm": ssm_caches, "attn": attn_caches})
    else:  # dense / moe
        caches = []
        for bp in params.blocks:
            h, cache = self_prefill(bp, h)
            caches.append(cache)
        state = DecodeState(caches=caches)

    h = apply_norm(params.final_norm, h[:, -1:], cfg.norm)
    return h @ lm_head_weight(params, cfg), state


@torch.inference_mode()
def decode_step(params: TransformerLM, cfg: ArchConfig, token: torch.Tensor,
                state: DecodeState):
    """One token int[B, 1] -> (logits [B, 1, V], state); the state's caches
    are written and advanced in place. The audio encoder has no decode
    step (``ValueError``, as in the reference)."""
    if cfg.family == "audio":
        raise ValueError(f"decode unsupported for family {cfg.family}")
    h = embed_tokens(params, cfg, token)

    if cfg.xlstm:
        s_cache, m_cache = state.caches["s"], state.caches["m"]
        for i in range(cfg.n_layers):
            is_s, p = _xlstm_layer(params, i)
            li = i // 2
            if is_s:
                y, s_cache[li] = xlstm_mod.slstm_forward(
                    p, h, cfg.n_heads, cache=s_cache[li])
            else:
                y, m_cache[li] = xlstm_mod.mlstm_decode_step(
                    p, h, m_cache[li], cfg.n_heads)
            h = h + y
        h = apply_norm(params.final_norm, h, cfg.norm)
        return h @ lm_head_weight(params, cfg), state

    def self_decode(bp, x, cache):
        hn = apply_norm(bp["attn_norm"], x, cfg.norm)
        a, _ = attn.decode_self_attention(
            bp["attn"], hn, cache, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, rope=cfg.rope, window=cfg.window)
        x = x + a
        y, _ = _mlp_or_moe(bp, cfg, apply_norm(bp["mlp_norm"], x, cfg.norm))
        return x + y

    if cfg.family == "vlm":
        for self_ps, cross_p, caches, kv in zip(
                params.self_blocks, params.cross_blocks, state.caches,
                state.cross_kv):
            for bp, cache in zip(self_ps, caches):
                h = self_decode(bp, h, cache)
            hn = apply_norm(cross_p["attn_norm"], h, cfg.norm)
            h = h + attn.decode_cross_attention(
                cross_p["attn"], hn, kv, n_heads=cfg.n_heads, hd=cfg.hd)
            hn = apply_norm(cross_p["mlp_norm"], h, cfg.norm)
            h = h + apply_mlp(cross_p["mlp"], hn, cfg.act)
    elif cfg.family == "hybrid":
        for ssm_ps, ssm_caches, attn_cache in zip(
                params.ssm_blocks, state.caches["ssm"],
                state.caches["attn"]):
            for j, bp in enumerate(ssm_ps):
                hn = apply_norm(bp["norm"], h, cfg.norm)
                y, ssm_caches[j] = ssm_mod.ssd_decode_step(
                    bp["ssm"], hn, ssm_caches[j], cfg.ssm)
                h = h + y
            h = self_decode(params.shared_block, h, attn_cache)
    else:  # dense / moe
        for bp, cache in zip(params.blocks, state.caches):
            h = self_decode(bp, h, cache)

    h = apply_norm(params.final_norm, h, cfg.norm)
    return h @ lm_head_weight(params, cfg), state
