"""Optimizers without a library (port of ``repro.optim``): SGD, momentum
(optionally Nesterov) and AdamW, each an (init, step) pair.

    opt = sgd(lr) | momentum(lr, beta, nesterov) | adamw(lr, ...)
    state = opt.init(params)
    params, state = opt.step(params, grads, state)

``params`` is a ``{name: tensor}`` mapping or an ``nn.Module``; ``grads`` a
mapping with the same names. On a mapping ``step`` returns a new mapping,
as the reference returns a new tree; on a module it writes the new values
into its parameters and returns the module. SGD and momentum compute in the
parameters' dtype, as the reference does; AdamW keeps its moments in f32
and rounds the update to the parameter's dtype once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    step: Callable
    name: str = "opt"


def _leaves(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _apply(params, new: dict):
    """The new values as ``params`` holds them: a new mapping, or written
    into the module."""
    if not isinstance(params, nn.Module):
        return new
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(new[n])
    return params


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def step(params, grads: Mapping, state):
        new = {n: p - lr * grads[n] for n, p in _leaves(params).items()}
        return _apply(params, new), state

    return Optimizer(init, step, "sgd")


def momentum(lr: float, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return {n: torch.zeros_like(p) for n, p in _leaves(params).items()}

    @torch.no_grad()
    def step(params, grads: Mapping, m: dict):
        m = {n: beta * mi + grads[n] for n, mi in m.items()}
        upd = ({n: beta * mi + grads[n] for n, mi in m.items()}
               if nesterov else m)
        new = {n: p - lr * upd[n] for n, p in _leaves(params).items()}
        return _apply(params, new), m

    return Optimizer(init, step, "momentum")


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor     # int32 scalar


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        leaves = _leaves(params)

        def zeros():
            return {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in leaves.items()}

        device = next(iter(leaves.values())).device if leaves else "cpu"
        return AdamState(mu=zeros(), nu=zeros(),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))

    @torch.no_grad()
    def step(params, grads: Mapping, state: AdamState):
        c = state.count + 1
        mu = {n: b1 * m + (1 - b1) * grads[n].float()
              for n, m in state.mu.items()}
        nu = {n: b2 * v + (1 - b2) * torch.square(grads[n].float())
              for n, v in state.nu.items()}
        cf = c.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new = {n: upd(p, mu[n], nu[n]) for n, p in _leaves(params).items()}
        return _apply(params, new), AdamState(mu=mu, nu=nu, count=c)

    return Optimizer(init, step, "adamw")
