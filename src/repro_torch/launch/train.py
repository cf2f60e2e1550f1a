"""The dense LM train step (port of ``repro.launch.train``'s ``loss_fn`` and
``make_dense_train_step``): plain SGD on the gradient of ``train_loss``,
optionally accumulated over microbatches.

The reference takes ``jax.value_and_grad`` of a pure function of the
parameter tree; the port's parameters live in a ``TransformerLM`` created
with ``requires_grad=False`` (serving), so ``value_and_grad`` turns grad on
for the call and restores it. Gradients are returned by parameter name
(``blocks.0.attn.wq``), in each parameter's dtype;
``convert.lm_tree_to_numpy`` stacks them into the reference's tree.

The federated step builders (``make_fl_train_step``, ``_v2``,
``fl_leaf_plan``, ``init_fl_residuals``) are not ported here.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def loss_fn(params: tf.TransformerLM, cfg: ArchConfig,
            batch: dict) -> torch.Tensor:
    return tf.train_loss(params, cfg, batch)


def value_and_grad(params: tf.TransformerLM, cfg: ArchConfig, batch: dict):
    """(loss, {name: gradient}) of ``loss_fn``, the loss detached. A leaf
    the loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    names, leaves = zip(*params.named_parameters())
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for n, p, g in zip(names, leaves, grads)}


def micro_batches(n_params: int) -> int:
    """Microbatches a dense step takes for a model of ``n_params``
    parameters (the reference's dry-run rule: the activation footprint
    grows with the model)."""
    if n_params > 50e9:
        return 8
    if n_params > 12e9:
        return 4
    return 2 if n_params > 4e9 else 1


def step_gradients(params: tf.TransformerLM, cfg: ArchConfig, batch: dict,
                   n_micro: int = 1):
    """(loss, {name: gradient}) of one dense step. With ``n_micro > 1`` the
    batch splits along dim 0 into ``n_micro`` microbatches whose gradients
    add up in f32 in microbatch order; loss and gradients are then divided
    by ``n_micro`` (f32 gradients, where ``n_micro == 1`` keeps each
    parameter's dtype)."""
    if n_micro == 1:
        return value_and_grad(params, cfg, batch)
    micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
             for k, v in batch.items()}
    device = next(params.parameters()).device
    loss = torch.zeros((), dtype=torch.float32, device=device)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    for i in range(n_micro):
        mb_loss, g = value_and_grad(params, cfg,
                                    {k: v[i] for k, v in micro.items()})
        loss = loss + mb_loss
        for n, gi in g.items():
            grads[n] += gi.float()
    for g in grads.values():
        g /= n_micro
    return loss / n_micro, grads


@torch.no_grad()
def sgd_update(params: tf.TransformerLM, grads: dict, lr: float) -> None:
    """``p = (p.f32 - lr * g.f32).to(p.dtype)``, written into the
    parameters (the reference returns a new tree with the same numbers)."""
    for n, p in params.named_parameters():
        p.copy_((p.float() - lr * grads[n].float()).to(p.dtype))


def make_dense_train_step(cfg: ArchConfig, lr: float = 0.01,
                          n_micro: int = 1) -> Callable:
    """``step(params, batch) -> (params, loss)``: one SGD step,
    ``step_gradients`` then ``sgd_update``; the parameters are updated in
    place and returned."""

    def step(params: tf.TransformerLM, batch: dict):
        loss, grads = step_gradients(params, cfg, batch, n_micro)
        sgd_update(params, grads, lr)
        return params, loss

    return step
