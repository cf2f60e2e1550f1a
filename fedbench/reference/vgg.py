"""Plain PyTorch VGG16 with batch-statistics BatchNorm, as the configuration
file states it, in float32: the reference that the timed round is held to.

Parameters are a ``{name: tensor}`` dict, one two-level name a leaf
(``c{i}.w`` a convolution's HWIO kernel, ``c{i}.b`` its bias, ``bn{i}.scale``
and ``bn{i}.bias`` the BatchNorm's affine map, ``head.w`` as ``[in, out]``),
leaves ordered by their outer then inner name as strings: the order in which
the paper's protocol numbers leaves (per-leaf rates, mask seeds). Inputs are
NHWC. Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def leaf_shapes(config: dict) -> dict:
    """``{name: shape}`` in leaf order."""
    shapes, cin, i = {}, config["input_shape"][2], 0
    k = config["kernel_size"]
    for v in config["conv_channels"]:
        if v == "M":
            continue
        shapes[f"c{i}.w"] = (k, k, cin, v)
        shapes[f"c{i}.b"] = (v,)
        shapes[f"bn{i}.scale"] = (v,)
        shapes[f"bn{i}.bias"] = (v,)
        cin, i = v, i + 1
    h = config["input_shape"][0] >> sum(v == "M" for v in config["conv_channels"])
    n_in = h * h * cin
    if len(config["head"]) != 1:
        raise ValueError("the reference has one dense head layer")
    shapes["head.w"] = (n_in, config["head"][0])
    shapes["head.b"] = (config["head"][0],)

    def key(name):
        outer, inner = name.split(".")
        return (outer, inner)
    return {n: shapes[n] for n in sorted(shapes, key=key)}


def init_params(config: dict, generator: torch.Generator,
                device) -> dict:
    """He-normal kernels and head, zero biases, unit BatchNorm scales: one
    draw of every normal value on ``device``, then scaled leaf by leaf."""
    shapes = leaf_shapes(config)
    normal = [n for n in shapes if n.endswith(".w")]
    sizes = [int(torch.Size(shapes[n]).numel()) for n in normal]
    z = torch.randn(sum(sizes), generator=generator, device=device,
                    dtype=torch.float32)
    out, o = {}, 0
    for n in shapes:
        if n in normal:
            size = int(torch.Size(shapes[n]).numel())
            fan_in = size // shapes[n][-1]
            out[n] = z[o:o + size].reshape(shapes[n]) * (2.0 / fan_in) ** 0.5
            o += size
        elif n.endswith(".scale"):
            out[n] = torch.ones(shapes[n], device=device)
        else:
            out[n] = torch.zeros(shapes[n], device=device)
    return out


def apply(config: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits of NHWC images ``x``."""
    h, i = x.permute(0, 3, 1, 2), 0
    pad = config["kernel_size"] // 2
    for v in config["conv_channels"]:
        if v == "M":
            h = F.max_pool2d(h, 2)
            continue
        h = F.conv2d(h, p[f"c{i}.w"].permute(3, 2, 0, 1), p[f"c{i}.b"],
                     padding=pad)
        h = F.batch_norm(h, None, None, p[f"bn{i}.scale"], p[f"bn{i}.bias"],
                         training=True, eps=config["bn_eps"])
        h = torch.relu(h)
        i += 1
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return h @ p["head.w"] + p["head.b"]


def loss(config: dict, p: dict, x: torch.Tensor, y: torch.Tensor):
    """Mean softmax cross-entropy."""
    logp = torch.log_softmax(apply(config, p, x), -1)
    return -torch.gather(logp, 1, y[:, None].to(torch.int64)).mean()


def local_sgd(config: dict, params: dict, xs: torch.Tensor, ys: torch.Tensor,
              lr: float) -> tuple:
    """One client's local SGD over ``xs[steps, B, ...]``: (delta, mean loss)."""
    p = {n: t.detach().clone() for n, t in params.items()}
    losses = []
    for s in range(xs.shape[0]):
        leaves = {n: t.requires_grad_() for n, t in p.items()}
        with torch.enable_grad():
            value = loss(config, leaves, xs[s], ys[s])
            grads = torch.autograd.grad(value, list(leaves.values()))
        p = {n: (t - lr * g).detach() for (n, t), g in zip(leaves.items(),
                                                            grads)}
        losses.append(float(value.detach()))
    delta = {n: p[n] - params[n] for n in params}
    return delta, sum(losses) / len(losses)
