"""JAX's default PRNG, threefry-2x32, bit for bit (the draws of
``jax.random`` with ``jax_threefry_partitionable = True``, the default of
JAX 0.9).

The datacenter FL step keys its pairwise masks with ``jax.random``
(``core/streams.py::pairwise_mask_rows``). The unified stream sends the
gradient value at every first-occurrence mask position, so other draws
would send other gradient coordinates: only the same bits make the port's
step comparable with the reference's. Threefry is XLA in the reference,
not a Pallas kernel, so plain PyTorch is its port.

A key is a uint32 pair ``(k0, k1)`` held in an int64 tensor of shape
``[2]`` on the CPU, every lane masked to 32 bits; the draws take a batch
of keys ``[..., 2]`` too (JAX's ``vmap`` over keys). ``key(seed)`` is
``(0, seed mod 2**32)``: JAX without x64 converts a Python seed to int32,
whose logical shift by 32 is 0. The key functions (:func:`fold_in`,
:func:`split`) run on Python ints (tens of microseconds a call, where a
few hundred tiny tensor ops would take milliseconds); the draws run as
int64 tensor ops on the caller's device.

The draws:

* ``random_bits(key, shape)``: threefry of the counter ``i`` (the flat
  row-major position as a uint64: high word, low word), ``bits1 ^ bits2``;
* ``split(key, n)``: row ``i`` is ``threefry(key, (0, i))``, both words;
* ``fold_in(key, d)``: ``threefry(key, (0, d))``, both words;
* ``randint``: two ``random_bits`` from ``split(key)`` (high, low), each
  reduced mod the span and combined as ``(hi % s) * (2**32 % s) + lo % s``
  in uint32 arithmetic that wraps, mod the span again;
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, then ``max(lo, u * (hi - lo) + lo)``, the multiply-add rounded once:
  XLA contracts it into an FMA at every shape (probed on the CPU against
  the two-rounding form, which differs in ~15–50% of draws where the span
  is not a power of 2). ``kernels/ref.py::_fma_f32`` rounds it once here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import _fma_f32

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under the key ``(k0, k1)``. Works on Python ints and on int64
    tensors holding uint32 values (broadcast against each other); returns
    the two output words, masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & M32
    b = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = ((b << r) & M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def _as_key(key) -> torch.Tensor:
    key = torch.as_tensor(key, dtype=torch.int64)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] uint32 words, got shape "
                         f"{tuple(key.shape)}")
    return key


def _words(key) -> tuple[int, int]:
    """One key's two words as Python ints."""
    key = _as_key(key)
    if key.dim() != 1:
        raise ValueError(f"one key of shape [2] expected, got "
                         f"{tuple(key.shape)}")
    k0, k1 = key.tolist()
    return k0, k1


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``'s data: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``threefry(key, (0, data))``,
    ``data`` taken mod 2**32 (JAX's uint32 conversion)."""
    return torch.tensor(threefry2x32(*_words(key), 0, int(data) & M32),
                        dtype=torch.int64)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (the partitionable, fold-like
    split): ``[num, 2]`` keys, row ``i`` ``threefry(key, (0, i))``."""
    k0, k1 = _words(key)
    return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                        dtype=torch.int64)


def random_bits(key, shape, *, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 lanes on
    ``device``. A batch of keys ``[..., 2]`` gives ``[..., *shape]``, each
    key's draws from its own counters (JAX's ``vmap`` over keys)."""
    key = _as_key(key)
    shape = tuple(int(d) for d in shape)
    device = key.device if device is None else torch.device(device)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    kd = key.to(device)
    lead = tuple(kd.shape[:-1])
    k0 = kd[..., 0].reshape(lead + (1,))
    k1 = kd[..., 1].reshape(lead + (1,))
    a, b = threefry2x32(k0, k1, i >> 32, i & M32)
    return (a ^ b).reshape(lead + shape)


def randint(key, shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``:
    int32 on ``device``; a batch of keys ``[..., 2]`` gives ``[...,
    *shape]``."""
    key = _as_key(key)
    pairs = [randint_keys(k) for k in key.reshape(-1, 2).tolist()]
    sub = torch.tensor([[p[j] for p in pairs] for j in (0, 1)])
    bits = random_bits(sub.reshape((2,) + tuple(key.shape)), shape,
                       device=device)
    return randint_from_bits(bits[0], bits[1], minval, maxval)


def randint_keys(key) -> tuple:
    """The keys of :func:`randint`'s two draws (high bits, low bits):
    ``split(key)``, as Python ints."""
    k0, k1 = (int(x) for x in key)
    return threefry2x32(k0, k1, 0, 0), threefry2x32(k0, k1, 0, 1)


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor,
                      minval: int, maxval: int) -> torch.Tensor:
    """:func:`randint` from its two draws of 32 bits (int64 lanes)."""
    i32 = (-2 ** 31, 2 ** 31 - 1)
    out_of_range = maxval > i32[1]
    lo = min(max(int(minval), i32[0]), i32[1])
    hi = min(max(int(maxval), i32[0]), i32[1])
    span = (hi - lo) & M32
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & M32
    if span == 0:   # a span of 2**32 wrapped: the remainders are the bits
        offset = lower
    else:
        mult = (2 ** 16) % span
        mult = ((mult * mult) & M32) % span
        offset = ((((higher % span) * mult) & M32) + lower % span) & M32
        offset = offset % span
    return ((lo + offset + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0, *,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``
    (f32 on ``device``; a batch of keys ``[..., 2]`` gives ``[...,
    *shape]``): ``max(lo, fma(u, hi - lo, lo))`` with ``lo``, ``hi`` and
    their difference in f32."""
    return uniform_from_bits(random_bits(key, shape, device=device), minval,
                             maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float,
                      maxval: float) -> torch.Tensor:
    """:func:`uniform` from its draw of 32 bits (int64 lanes)."""
    f32 = torch.float32
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(f32) - 1.0
    lo = torch.tensor(float(minval), dtype=f32)
    hi = torch.tensor(float(maxval), dtype=f32)
    span = (hi - lo).item()
    out = _fma_f32(span, u, lo.item())
    return torch.maximum(out, lo.to(out.device))
