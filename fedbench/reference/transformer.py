"""A plain decoder-only LM (RMSNorm, RoPE, grouped-query causal attention,
SwiGLU) in float32 with TF32 off, as the configuration file states it: the
reference that the timed training step is held to.

Parameters are a ``{name: tensor}`` dict: ``embed [V, d]``, per block
``blocks.{i}.attn_norm.scale``, ``blocks.{i}.attn.{wq,wk,wv,wo}`` (``[in,
out]``), ``blocks.{i}.mlp_norm.scale``, ``blocks.{i}.mlp.{wi_gate,wi_up,wo}``,
then ``final_norm.scale`` and ``lm_head [d, V]``. ``precision="fp8"`` is the
control: every projection's operands rounded to float8 e4m3 with one scale a
tensor before the f32 product. Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def head_dim(config: dict) -> int:
    return config["d_model"] // config["n_heads"]


def leaf_shapes(config: dict) -> dict:
    """``{name: (shape, init std or None for a unit scale)}``, in the order
    the weights are drawn."""
    d, f, V = config["d_model"], config["d_ff"], config["vocab"]
    q = config["n_heads"] * head_dim(config)
    kv = config["n_kv_heads"] * head_dim(config)

    def dense(a, b):
        return (a, b), math.sqrt(2.0 / (a + b))
    out = {"embed": ((V, d), 0.02)}
    for i in range(config["n_layers"]):
        b = f"blocks.{i}."
        out[b + "attn_norm.scale"] = ((d,), None)
        out[b + "attn.wq"] = dense(d, q)
        out[b + "attn.wk"] = dense(d, kv)
        out[b + "attn.wv"] = dense(d, kv)
        out[b + "attn.wo"] = dense(q, d)
        out[b + "mlp_norm.scale"] = ((d,), None)
        out[b + "mlp.wi_gate"] = dense(d, f)
        out[b + "mlp.wi_up"] = dense(d, f)
        out[b + "mlp.wo"] = dense(f, d)
    out["final_norm.scale"] = ((d,), None)
    out["lm_head"] = ((d, V), 0.02)
    return out


def init_params(config: dict, generator: torch.Generator, device,
                dtype=torch.bfloat16) -> dict:
    """Every normal weight from ONE draw of the configuration's dtype on
    ``device``, scaled leaf by leaf in place; unit norm scales. The same
    generator state gives the same weights."""
    shapes = leaf_shapes(config)
    n = sum(math.prod(s) for s, std in shapes.values() if std is not None)
    flat = torch.randn(n, generator=generator, device=device,
                       dtype=getattr(torch, config["dtype"]))
    out, o = {}, 0
    for name, (shape, std) in shapes.items():
        if std is None:
            out[name] = torch.ones(shape, device=device, dtype=dtype)
            continue
        size = math.prod(shape)
        view = flat[o:o + size].view(shape)
        view.mul_(std)
        out[name] = view if view.dtype == dtype else view.to(dtype)
        o += size
    return out


def _q8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _mm(x, w, prec):
    if prec == "fp8":
        return _q8(x) @ _q8(w)
    return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    t, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.float32) / hd))
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, chunk):
    """Causal GQA attention, queries in chunks of ``chunk``."""
    b, t, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, 2).transpose(1, 2)
    v = v.repeat_interleave(g, 2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for s in range(0, t, chunk):
        sc = q[:, :, s:s + chunk] @ k.transpose(-1, -2) / math.sqrt(hd)
        pos = torch.arange(s, min(s + chunk, t), device=q.device)[:, None]
        sc = sc.masked_fill(torch.arange(t, device=q.device)[None] > pos,
                            float("-inf"))
        outs.append(torch.softmax(sc, -1) @ v)
    return torch.cat(outs, 2).transpose(1, 2)


def _block(config, p, i, x, prec):
    b = f"blocks.{i}."
    B, T, _ = x.shape
    hd = head_dim(config)
    eps, theta = config["norm_eps"], config["rope_theta"]
    h = _rms(x, p[b + "attn_norm.scale"], eps)
    q = _mm(h, p[b + "attn.wq"], prec).view(B, T, config["n_heads"], hd)
    k = _mm(h, p[b + "attn.wk"], prec).view(B, T, config["n_kv_heads"], hd)
    v = _mm(h, p[b + "attn.wv"], prec).view(B, T, config["n_kv_heads"], hd)
    a = _attention(_rope(q, theta), _rope(k, theta), v,
                   config["attn_chunk"]).reshape(B, T, -1)
    x = x + _mm(a, p[b + "attn.wo"], prec)
    h = _rms(x, p[b + "mlp_norm.scale"], eps)
    y = torch.nn.functional.silu(_mm(h, p[b + "mlp.wi_gate"], prec)) * _mm(
        h, p[b + "mlp.wi_up"], prec)
    return x + _mm(y, p[b + "mlp.wo"], prec)


def loss(config: dict, p: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "float32") -> torch.Tensor:
    """Mean next-token cross-entropy; each block recomputed in the backward
    (checkpointed) so that the float32 step fits beside its weights."""
    x = p["embed"][tokens]
    for i in range(config["n_layers"]):
        x = checkpoint(_block, config, p, i, x, prec, use_reentrant=False)
    h = _rms(x, p["final_norm.scale"], config["norm_eps"])
    total = torch.zeros((), device=x.device)
    T = tokens.shape[1]
    c = min(config["loss_chunk"], T)
    for s in range(0, T // c * c, c):
        total = total + checkpoint(_chunk_ce, h[:, s:s + c], p["lm_head"],
                                   labels[:, s:s + c], prec,
                                   use_reentrant=False)
    return total / (T // c)


def _chunk_ce(h, w, y, prec):
    logits = _mm(h, w, prec)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())


def sgd_step(config: dict, params: dict, tokens, labels, lr: float, *,
             prec: str = "float32", rows: slice | None = None,
             alter: bool = False) -> tuple:
    """One SGD step of the configuration: the gradient in f32, ``p - lr g``
    in f32, stored in the configuration's dtype (here held in f32). Returns
    (loss, {name: gradient norm}); ``params`` updated in place. ``rows``
    takes part of the batch (the half-batch fault); ``alter`` adds 1 to
    the first element of every leaf's gradient (the altered-answer fault)."""
    if rows is not None:
        tokens, labels = tokens[rows], labels[rows]
    names = list(params)
    leaves = [params[n].requires_grad_() for n in names]
    with torch.enable_grad():
        value = loss(config, dict(zip(names, leaves)), tokens, labels, prec)
        grads = torch.autograd.grad(value, leaves)
    norms = {}
    store = getattr(torch, config["dtype"])
    with torch.no_grad():
        for n, t, g in zip(names, leaves, grads):
            if alter:
                g = g.clone()
                g.view(-1)[0] += 1.0
            norms[n] = float(g.double().norm())
            t.requires_grad_(False)
            t.copy_((t - lr * g).to(store).float())
    return float(value.detach()), norms
