"""Shared layer primitives: norms, RoPE variants, MLPs, initializers (port of
``repro.models.layers``).

As in the reference, a layer is a pair of functions over a parameter mapping:
``init_*`` builds it, ``apply_*`` consumes it. Here a mapping is an
``nn.ParameterDict`` (or any ``{name: tensor}`` dict), weights keep the
reference's ``[d_in, d_out]`` layout and a product is ``x @ w``. Draws come
from an explicit ``torch.Generator`` at the reference's scales; the numbers
differ from ``jax.random``'s, so parity tests load the reference's draws
(``convert.lm_params_from_jax``).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

Params = Mapping[str, torch.Tensor]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def _normal_(p: torch.Tensor, scale: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """``p = (scale * N(0, 1)).astype(p.dtype)``: drawn in f32 and cast once,
    as the reference does. Nothing is drawn without a generator or on the
    meta device (shapes only)."""
    if generator is None or p.device.type == "meta":
        return p
    z = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    z.normal_(generator=generator)
    return p.copy_(z.mul_(scale))


# ---------------------------------------------------------------- initializers
def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               dtype, device) -> nn.Parameter:
    """``[d_in, d_out]`` with std ``sqrt(2 / (d_in + d_out))``."""
    return _normal_(_param((d_in, d_out), dtype, device),
                    (2.0 / (d_in + d_out)) ** 0.5, generator)


def stacked_dense_init(generator: Optional[torch.Generator], n: int,
                       d_in: int, d_out: int, dtype, device) -> nn.Parameter:
    """``[n, d_in, d_out]``: n independent ``dense_init`` draws."""
    return _normal_(_param((n, d_in, d_out), dtype, device),
                    (2.0 / (d_in + d_out)) ** 0.5, generator)


def normal_init(generator: Optional[torch.Generator], shape, scale: float,
                dtype, device) -> nn.Parameter:
    """``scale * N(0, 1)`` of ``shape``, cast to ``dtype``."""
    return _normal_(_param(tuple(shape), dtype, device), scale, generator)


def const_init(values: torch.Tensor, dtype, device) -> nn.Parameter:
    """A parameter holding ``values`` (computed in f32, cast once); on the
    meta device shapes only."""
    p = _param(tuple(values.shape), dtype, device)
    if p.device.type != "meta":
        with torch.no_grad():
            p.copy_(values)
    return p


def embed_init(generator: Optional[torch.Generator], vocab: int, d: int, dtype,
               device) -> nn.Parameter:
    """``[vocab, d]`` with std 0.02."""
    return _normal_(_param((vocab, d), dtype, device), 0.02, generator)


# ----------------------------------------------------------------------- norms
def init_norm(d: int, kind: str, dtype, device) -> nn.ParameterDict:
    p = nn.ParameterDict({"scale": _param((d,), dtype, device)})
    if kind == "layernorm":
        p["bias"] = _param((d,), dtype, device)
    if p["scale"].device.type != "meta":
        with torch.no_grad():
            p["scale"].fill_(1.0)
            if "bias" in p:
                p["bias"].zero_()
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMS or layer norm, computed in f32 and cast back to ``x.dtype``."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ------------------------------------------------------------------------ RoPE
def rope_freqs(hd: int, positions: torch.Tensor, theta: float = 10000.0):
    """positions: int[...]; returns f32 (cos, sin) of shape
    ``positions.shape + (hd // 2,)``."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               mode: str = "default") -> torch.Tensor:
    """x: ``[..., T, H, hd]``; positions: ``[..., T]`` (broadcastable).

    ``default`` rotates the full head dim (split-half convention), ``2d``
    (ChatGLM) the first half only, ``none`` is the identity. cos/sin are
    computed in f32 and cast to ``x.dtype`` before the rotation, as in the
    reference.
    """
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot_d = hd if mode == "default" else hd // 2
    rot_d = rot_d - (rot_d % 2)
    xr, xp = x[..., :rot_d], x[..., rot_d:]
    cos, sin = rope_freqs(rot_d, positions)          # [..., T, rot_d/2]
    cos = cos[..., None, :].to(x.dtype)              # broadcast over heads
    sin = sin[..., None, :].to(x.dtype)
    x1, x2 = xr[..., : rot_d // 2], xr[..., rot_d // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rotated, xp], -1)


# ------------------------------------------------------------------------ MLPs
def init_mlp(generator: Optional[torch.Generator], d: int, d_ff: int, act: str,
             dtype, device) -> nn.ParameterDict:
    if act == "swiglu":
        p = {"wi_gate": dense_init(generator, d, d_ff, dtype, device),
             "wi_up": dense_init(generator, d, d_ff, dtype, device)}
    else:
        p = {"wi": dense_init(generator, d, d_ff, dtype, device)}
    p["wo"] = dense_init(generator, d_ff, d, dtype, device)
    return nn.ParameterDict(p)


def apply_mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = torch.nn.functional.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = torch.nn.functional.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
