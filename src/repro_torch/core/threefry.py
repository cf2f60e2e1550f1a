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
  is not a power of 2). ``kernels/ref.py::_fma_f32`` rounds it once here;
* ``normal``: ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, with XLA's f32 ``erf_inv`` (Giles'
  single-precision polynomial over ``-log1p(-u*u)``) and XLA's CPU
  ``log1p``: a Cephes rational below ``sqrt(2) - 1``, else the Cephes
  ``log`` of ``1 + x``. Every multiply-add that LLVM contracts into an FMA
  rounds once here (``_fma_f32``); the rest rounds as XLA does.
  ``torch.erfinv`` and ``torch.log1p`` round otherwise (up to 64 and 2
  ulp away, probed over a million draws), so neither is used.
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


# XLA's f32 erf_inv (stablehlo's chlo decomposition, Giles' polynomials in
# w = -log1p(-x*x), highest degree first): w < 5, then w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)
# XLA's log1p below sqrt(2) - 1: Cephes' rational (numerator, denominator)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's CPU log: Cephes' logf on the mantissa in [sqrt(1/2), sqrt(2))
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma_f32(p, x, c)
    return p


def _xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log`` of positive normal ``v``: the exponent split
    off, the mantissa shifted into ``[sqrt(1/2), sqrt(2)) - 1``, Cephes'
    degree-8 polynomial in three Horner parts, the exponent's ``ln 2`` added
    as two constants."""
    f32 = torch.float32
    bits = v.view(torch.int32)
    x = ((bits & ~0x7F800000) | 0x3F000000).view(f32)   # in [0.5, 1)
    e = ((bits >> 23) - 0x7E).to(f32)
    low = x < 0.707106781186547524
    e = e - low.to(f32)
    x = (x - 1.0) + torch.where(low, x, 0.0)
    x2 = x * x
    x3 = x2 * x
    y = _fma_f32(_fma_f32(_LOG_P[0], x, _LOG_P[1]), x, _LOG_P[2])
    y1 = _fma_f32(_fma_f32(_LOG_P[3], x, _LOG_P[4]), x, _LOG_P[5])
    y2 = _fma_f32(_fma_f32(_LOG_P[6], x, _LOG_P[7]), x, _LOG_P[8])
    y = _fma_f32(_fma_f32(y, x3, y1), x3, y2)
    y = _fma_f32(y, x3, -2.12194440e-4 * e)
    x = _fma_f32(-0.5, x2, x) + y
    return _fma_f32(0.693359375, e, x)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log1p`` for ``x > -1``."""
    x2 = x * x
    small = _horner(_LOG1P_P, x) / _horner(_LOG1P_Q, x)
    small = x + _fma_f32(-0.5, x2, (x * x2) * small)
    threshold = torch.tensor(0.41421356237309504880, dtype=torch.float32)
    return torch.where(x.abs() < threshold, small, _xla_log(1.0 + x))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` on ``(-1, 1)``, bit for bit on the CPU
    (``+-1`` give ``+-inf``)."""
    w = -_xla_log1p(x * -x)
    lt = w < 5.0
    # torch.sqrt in f32 is not always correctly rounded on the CPU; XLA's is
    root = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    w = torch.where(lt, w - 2.5, root - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32))
        p = c if p is None else _fma_f32(p, w, c)
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(key, shape, *, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.float32)`` (f32 on ``device``; a
    batch of keys ``[..., 2]`` gives ``[..., *shape]``): ``f32(sqrt 2) *
    erf_inv(uniform(key, shape, nextafter(-1, 0), 1))``."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32) * erf_inv(u)
