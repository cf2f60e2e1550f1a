"""The scatter kernel's zero-skip rule, pinned on the plain versions.

``csrc/stream_scatter_add.cu`` drops every stream entry whose value is +0.0
or -0.0 before it folds. That is exact: in round-to-nearest ``x + y`` is
-0.0 only when both are -0.0, so a fold that starts at +0.0 never holds
-0.0, and ``acc + (+-0.0) == acc`` bit for bit for every other ``acc``. The
tests below hold the arithmetic facts on f32 values, then hold the scatter
with the zeros dropped bit-equal to the scatter of the whole stream: the
port's plain version (both of its folds) and the JAX reference's scatter,
on streams with +0.0, -0.0, exact cancellations, +-inf, NaN, duplicates,
out-of-range indices and a tree decode's dump-slot stream.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -24, -(2.0 ** -24),
                    2.0 ** -149, -(2.0 ** -149), 3.4e38, -3.4e38, np.inf,
                    -np.inf, np.nan], np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(a, b):
    """Bit-equal, a NaN lane matching any NaN (payloads differ between
    numpy's, XLA's and torch's NaN)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    na, nb = np.isnan(a), np.isnan(b)
    return (a.shape == b.shape and np.array_equal(na, nb)
            and np.array_equal(_bits(a[~na]), _bits(b[~nb])))


def test_f32_sum_is_negative_zero_only_from_two_negative_zeros():
    rs = np.random.RandomState(0)
    x = np.concatenate([SPECIAL, rs.randn(500).astype(np.float32),
                        rs.randint(-2**31, 2**31, 500).astype(np.int32)
                        .view(np.float32)])
    with np.errstate(all="ignore"):
        s = x[:, None] + x[None, :]
        s = np.concatenate([s.ravel(), x + (-x)])
    neg_zero = _bits(s) == _bits(np.float32(-0.0))
    both = np.concatenate([
        ((_bits(x)[:, None] == _bits(np.float32(-0.0)))
         & (_bits(x)[None, :] == _bits(np.float32(-0.0)))).ravel(),
        np.zeros(len(x), bool)])
    assert np.array_equal(neg_zero, both)


def test_adding_a_signed_zero_keeps_every_accumulator_but_negative_zero():
    rs = np.random.RandomState(1)
    acc = np.concatenate([SPECIAL, rs.randn(5000).astype(np.float32),
                          rs.randint(-2**31, 2**31, 5000).astype(np.int32)
                          .view(np.float32)])
    acc = acc[_bits(acc) != _bits(np.float32(-0.0))]
    for z in (np.float32(0.0), np.float32(-0.0)):
        assert _same(acc + z, acc)


def _stream(kind, seed):
    """A stream of one kind of hazard (``size``, int32 indices, f32 values)."""
    rs = np.random.RandomState(seed)
    if kind == "dump-slot":
        # core/streams.py::_scatter_range: slots outside [lo, hi) go to
        # position width of a width + 1 buffer with +0.0
        n, full, lo, hi = 6000, 3000, 1000, 2000
        idx = rs.randint(0, full, n)
        vals = rs.randn(n).astype(np.float32)
        inside = (idx >= lo) & (idx < hi)
        return (hi - lo + 1,
                np.where(inside, idx - lo, hi - lo).astype(np.int32),
                np.where(inside, vals, 0.0).astype(np.float32))
    size, n = 257, 5000
    idx = rs.randint(-3, size + 3, n).astype(np.int32)     # -1s and >= size
    vals = (rs.randint(-2**23, 2**23, n) / 2.0**23).astype(np.float32)
    zero = rs.rand(n) < 0.4
    vals[zero] = np.where(rs.rand(zero.sum()) < 0.5, 0.0, -0.0)
    if kind == "cancellations":
        half = rs.choice(n, n // 4, replace=False)         # x then -x
        for s in half[: len(half) // 2]:
            if s + 1 < n:
                idx[s + 1], vals[s + 1] = idx[s], -vals[s]
    elif kind == "inf-nan":
        sp = rs.choice(n, 200, replace=False)
        vals[sp] = rs.choice(np.array([np.inf, -np.inf, np.nan], np.float32),
                             200)
    elif kind == "only-zeros":
        vals[:] = np.where(rs.rand(n) < 0.5, 0.0, -0.0)
    elif kind == "negative-zeros":
        # positions reached only by -0.0, or by -0.0 around one value
        vals[idx % 7 == 0] = -0.0
        idx[:50], vals[:50] = 11, -0.0
    elif kind == "order-sensitive":
        e = np.float32(2.0 ** -24)
        idx[idx == 5] = 6
        for s, v in zip((10, 2000, 4000, 4500), (1.0, 0.0, e, -1.0)):
            idx[s], vals[s] = 5, v
    return size, idx, vals


KINDS = ["zeros-mixed", "cancellations", "inf-nan", "only-zeros",
         "negative-zeros", "order-sensitive", "dump-slot"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_scatter_without_zero_entries_is_bit_equal(kind, seed):
    size, idx, vals = _stream(kind, seed)
    keep = vals != 0          # drops +0.0 and -0.0, keeps NaN and +-inf
    whole = tref.stream_scatter_add_ref(torch.from_numpy(idx),
                                        torch.from_numpy(vals), size).numpy()
    kept = tref.stream_scatter_add_ref(torch.from_numpy(idx[keep]),
                                       torch.from_numpy(vals[keep]),
                                       size).numpy()
    assert _same(kept, whole)
    assert not np.signbit(whole[whole == 0]).any()   # never -0.0
    # the fold the plain version takes for a tensor on the card
    valid = (idx >= 0) & (idx < size) & keep
    by_rank = tref.scatter_fold_by_rank(
        torch.from_numpy(idx[valid].astype(np.int64)),
        torch.from_numpy(vals[valid]), size).numpy()
    assert _same(by_rank, whole)
    # the JAX reference's scatter of the whole stream
    want = np.asarray(jref.stream_scatter_add_ref(jnp.asarray(idx),
                                                  jnp.asarray(vals), size))
    assert _same(kept, want)
    if kind == "dump-slot":
        assert _bits(whole[size - 1]) == 0                # +0.0 exactly
    if kind == "order-sensitive":
        assert whole[5] == 0.0
