"""The paper's benchmark models (§5, Table 1) as ``nn.Module``s — port of
``repro.models.paper_models``.

Parameter counts reproduce Table 1 exactly:
    MNIST-MLP   159,010     = MLP 784-200-10
    MNIST-CNN   582,026     = conv5x5x32 -> pool -> conv5x5x64 -> pool -> 1024-512-10
    CIFAR-MLP   5,852,170   = MLP 3072-1536-690-102-10
    CIFAR-VGG16 14,728,266  = VGG16 conv stack + BatchNorm + 512-10 classifier

Parameters keep the reference's layout, because the stream engine's indices
are flat positions inside each leaf and each leaf's id is folded into its
mask seeds: a two-level name ``outer.inner`` per leaf, leaves enumerated in
the reference's tree-flatten order (dict keys sorted as strings at each
level, so ``bn0, bn1, bn10, ..., c0, ...``), dense ``w`` as ``[in, out]`` and
conv ``w`` as HWIO. Inputs are NHWC as in the reference; the convolutions
permute to NCHW inside ``apply`` and back to NHWC before every flatten, so the
head weights mean what they mean in the reference.

``apply(params, x)`` is a pure function of a ``{name: tensor}`` dict (what
``torch.func`` differentiates); ``forward(x)`` applies the module's own
parameters. BatchNorm uses the batch's statistics, as the reference does.

Local SGD vmaps ``apply`` over clients (``core/fedavg.py``). The two ops
whose bits would then depend on how many clients share the call, the
convolution and the batch norm, run one client at a time
(:func:`per_client`); every other op is vmapped as it is.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

Params = Mapping[str, torch.Tensor]


class PaperModel(nn.Module):
    """A paper model: parameters in the reference layout plus its apply."""

    def __init__(self, name: str, specs: dict, apply_fn: Callable,
                 input_shape: tuple, n_classes: int = 10):
        super().__init__()
        self.name = name
        self.input_shape = tuple(input_shape)
        self.n_classes = n_classes
        self._apply_fn = apply_fn
        self._specs = specs    # {outer: {inner: (shape, init kind, scale)}}
        self.layers = nn.ModuleDict({
            outer: nn.ParameterDict({
                inner: nn.Parameter(torch.zeros(shape))
                for inner, (shape, _, _) in sorted(leaves.items())})
            for outer, leaves in sorted(specs.items())})

    def leaf_names(self) -> list[str]:
        """``outer.inner`` names in the reference's tree-flatten order."""
        return [f"{o}.{i}" for o, leaves in sorted(self._specs.items())
                for i in sorted(leaves)]

    def params(self) -> dict[str, torch.Tensor]:
        """The module's parameters as an ordered ``{name: tensor}`` dict."""
        return {n: self.layers[n.split(".")[0]][n.split(".")[1]]
                for n in self.leaf_names()}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self._apply_fn(params, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_fn(self.params(), x)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "PaperModel":
        """He-normal weights (the reference's scales), zero biases, unit BN
        scales — drawn from ``generator`` in leaf order."""
        for name in self.leaf_names():
            outer, inner = name.split(".")
            shape, kind, scale = self._specs[outer][inner]
            p = self.layers[outer][inner]
            if kind == "normal":
                z = torch.randn(shape, generator=generator,
                                device=generator.device)
                p.copy_(scale * z)
            elif kind == "ones":
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.params().values())


def _dense(n_in, n_out, scale: float = 1.0) -> dict:
    return {"w": ((n_in, n_out), "normal", scale * (2.0 / n_in) ** 0.5),
            "b": ((n_out,), "zeros", 0.0)}


def _conv(kh, kw, cin, cout) -> dict:
    return {"w": ((kh, kw, cin, cout), "normal", (2.0 / (kh * kw * cin)) ** 0.5),
            "b": ((cout,), "zeros", 0.0)}


def _bn(c) -> dict:
    return {"scale": ((c,), "ones", 0.0), "bias": ((c,), "zeros", 0.0)}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _flatten_nhwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class _PerClient(torch.autograd.Function):
    """``fn(*args)``; under ``vmap``, ``fn`` once per client on that
    client's unbatched arguments, the results stacked (:func:`per_client`).
    Its backward is ``fn``'s own (``torch.func.vjp``, ``fn`` run again)."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        return (None,) + torch.func.vjp(ctx.fn, *ctx.saved_tensors)[1](g)

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        # unbind, not indexing: autograd then stacks the clients' gradients
        # once instead of scattering each into a zeroed whole
        per = [(a,) * info.batch_size if d is None
               else a.movedim(d, 0).unbind(0)
               for a, d in zip(args, in_dims[1:])]
        return torch.stack([fn(*a) for a in zip(*per)]), 0


def per_client(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)`` (tensors in, one tensor out), run one client at a
    time under ``vmap``.

    Local SGD vmaps ``apply`` over the clients (``core/fedavg.py``). With
    per-client weights ``vmap`` lowers a convolution to one grouped
    convolution, ``groups`` = clients, and oneDNN and cuDNN pick their
    algorithm by the group count; on the card a batch norm's reduction
    over ``(B, H, W)`` splits across blocks by its number of outputs
    (clients x channels). Either way a client's bits would move with the
    cohort or shard size. Through ``per_client`` each client computes
    ``fn`` at its own unbatched shape, whatever the number of clients.
    Local SGD differentiates the vmapped forward with autograd, which
    records these per-client ops, so their backward runs per client as
    well."""
    return _PerClient.apply(fn, *args)


def _conv2d(h, w, b, padding: int):
    """NCHW activations x an HWIO kernel."""
    return F.conv2d(h, w.permute(3, 2, 0, 1), b, padding=padding)


def _conv_bn(h, w, b, scale, bias, padding: int, eps: float = 1e-5):
    """:func:`_conv2d`, then batch-statistics BN: the reference's mean,
    biased variance and affine map, as ATen's fused batch norm
    (``torch.native_batch_norm`` runs ATen's own kernels, never
    cuDNN's)."""
    return torch.native_batch_norm(_conv2d(h, w, b, padding), scale, bias,
                                   None, None, True, 0.0, eps)[0]


# ------------------------------------------------------------------ MLPs
def make_mlp(dims) -> Callable[[], PaperModel]:
    n = len(dims) - 1

    def apply(p: Params, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for i in range(n):
            h = h @ p[f"l{i}.w"] + p[f"l{i}.b"]
            if i < n - 1:
                h = torch.relu(h)
        return h

    shape = (32, 32, 3) if dims[0] == 3072 else (28, 28, 1)

    def build() -> PaperModel:
        specs = {f"l{i}": _dense(dims[i], dims[i + 1]) for i in range(n)}
        return PaperModel(f"mlp{tuple(dims)}", specs, apply, shape)

    return build


# ------------------------------------------------------------------ MNIST CNN
def _mnist_cnn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(per_client(functools.partial(_conv2d, padding=0),
                              _nchw(x), p["c1.w"], p["c1.b"]))   # 24
    h = F.max_pool2d(h, 2)                                       # 12
    h = torch.relu(per_client(functools.partial(_conv2d, padding=0),
                              h, p["c2.w"], p["c2.b"]))          # 8
    h = F.max_pool2d(h, 2)                                       # 4
    h = _flatten_nhwc(h)                                         # 1024
    h = torch.relu(h @ p["f1.w"] + p["f1.b"])
    return h @ p["f2.w"] + p["f2.b"]


def _mnist_cnn() -> PaperModel:
    specs = {"c1": _conv(5, 5, 1, 32), "c2": _conv(5, 5, 32, 64),
             "f1": _dense(1024, 512, scale=0.5),
             "f2": _dense(512, 10, scale=0.1)}
    return PaperModel("mnist_cnn", specs, _mnist_cnn_apply, (28, 28, 1))


# ------------------------------------------------------------------ VGG16+BN
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]


def _vgg_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h, i = _nchw(x), 0
    for v in _VGG_CFG:
        if v == "M":
            h = F.max_pool2d(h, 2)
            continue
        h = torch.relu(per_client(
            functools.partial(_conv_bn, padding=1), h, p[f"c{i}.w"],
            p[f"c{i}.b"], p[f"bn{i}.scale"], p[f"bn{i}.bias"]))
        i += 1
    h = _flatten_nhwc(h)                   # 1x1x512 after 5 pools on 32x32
    return h @ p["head.w"] + p["head.b"]


def _vgg16() -> PaperModel:
    specs, cin, i = {}, 3, 0
    for v in _VGG_CFG:
        if v == "M":
            continue
        specs[f"c{i}"] = _conv(3, 3, cin, v)
        specs[f"bn{i}"] = _bn(v)
        cin, i = v, i + 1
    specs["head"] = _dense(512, 10)
    return PaperModel("cifar_vgg16", specs, _vgg_apply, (32, 32, 3))


PAPER_MODELS: dict[str, Callable[[], PaperModel]] = {
    "mnist_mlp": make_mlp((784, 200, 10)),
    "mnist_cnn": _mnist_cnn,
    "cifar_mlp": make_mlp((3072, 1536, 690, 102, 10)),
    "cifar_vgg16": _vgg16,
}

# Table 1 published parameter sizes
TABLE1_PARAMS = {
    "mnist_mlp": 159_010,
    "mnist_cnn": 582_026,
    "cifar_mlp": 5_852_170,
    "cifar_vgg16": 14_728_266,
}


def build_model(name: str, device="cpu") -> PaperModel:
    """A paper model with zeroed parameters on ``device``."""
    try:
        factory = PAPER_MODELS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{', '.join(sorted(PAPER_MODELS))}") from None
    return factory().to(device)


def cross_entropy_loss(model: PaperModel):
    """``loss(params, (x, y))``: mean softmax cross-entropy."""
    def loss_fn(params: Params, batch) -> torch.Tensor:
        x, y = batch
        logp = torch.log_softmax(model.apply(params, x), -1)
        return -torch.gather(logp, 1, y[:, None].to(torch.int64)).mean()

    return loss_fn


@torch.no_grad()
def accuracy(model: PaperModel, params: Params, x: torch.Tensor,
             y: torch.Tensor, batch: int = 500) -> float:
    correct = 0
    for i in range(0, len(x), batch):
        logits = model.apply(params, x[i:i + batch])
        correct += int((logits.argmax(-1) == y[i:i + batch]).sum())
    return correct / len(x)
