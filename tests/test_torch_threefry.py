"""Port parity: ``core/threefry.py`` against ``jax.random``, compared as
bits.

JAX 0.9's default PRNG is threefry-2x32 with ``jax_threefry_partitionable``
on; the port reproduces ``key``, ``fold_in``, ``split``, ``bits``,
``randint`` (int32, two draws, the span and multiplier arithmetic in
wrapping uint32) and ``uniform`` (f32; the multiply-add rounded once, as
XLA contracts it) over odd and large shapes, spans that are not powers of
2, batched keys (``vmap``), and mask ranges ``(p, q)`` other than the
reference's default ``(-1, 2)``. No tolerance: every draw is bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import threefry  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 2, -1, 123456789, 2 ** 40 + 3]
SHAPES = [(1,), (7,), (24,), (25,), (3, 5), (257, 33), (100003,)]
SPANS = [(0, 10), (0, 1000003), (5, 6), (-3, 17), (0, 2 ** 31 - 1),
         (3, 3), (0, 176128), (-(2 ** 31), 2 ** 31 - 1)]
PQ = [(-1.0, 2.0), (-1.5, 3.0), (-0.7, 1.3), (0.1, 0.3), (1e-10, 1.0)]


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_partitionable_threefry_is_the_default():
    # the draws below are those of the partitionable layout
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_is_bit_equal(seed):
    np.testing.assert_array_equal(threefry.key(seed).numpy(),
                                  _data(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 5, 31, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_is_bit_equal(data):
    k = jax.random.key(7)
    np.testing.assert_array_equal(threefry.fold_in(threefry.key(7), data)
                                  .numpy(), _data(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("num", [1, 2, 5, 64])
def test_split_is_bit_equal(num):
    k = jax.random.key(11)
    np.testing.assert_array_equal(threefry.split(threefry.key(11), num)
                                  .numpy(), _data(jax.random.split(k, num)))


def test_batched_keys_match_vmap():
    ks = jax.random.split(jax.random.key(3), 4)
    tks = threefry.split(threefry.key(3), 4)
    for i in range(4):
        np.testing.assert_array_equal(threefry.split(tks[i]).numpy(),
                                      _data(jax.random.split(ks[i])))
    with pytest.raises(ValueError, match="one key"):
        threefry.fold_in(tks, 9)
    np.testing.assert_array_equal(
        threefry.random_bits(tks, (5, 3)).numpy(),
        np.asarray(jax.vmap(lambda x: jax.random.bits(x, (5, 3)))(ks))
        .astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_are_bit_equal(shape):
    k = jax.random.key(5)
    np.testing.assert_array_equal(
        threefry.random_bits(threefry.key(5), shape).numpy(),
        np.asarray(jax.random.bits(k, shape)).astype(np.int64))


@pytest.mark.parametrize("lo,hi", SPANS)
@pytest.mark.parametrize("shape", SHAPES[:-1])
def test_randint_is_bit_equal(shape, lo, hi):
    k = jax.random.key(3)
    want = np.asarray(jax.random.randint(k, shape, lo, hi, jnp.int32))
    got = threefry.randint(threefry.key(3), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", SPANS[:4])
def test_randint_batched_and_large(lo, hi):
    ks = jax.random.split(jax.random.key(8), 3)
    want = np.asarray(jax.vmap(
        lambda x: jax.random.randint(x, (2, 50001), lo, hi, jnp.int32))(ks))
    got = threefry.randint(threefry.split(threefry.key(8), 3), (2, 50001),
                           lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,q", PQ)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_is_bit_equal(shape, p, q):
    k = jax.random.key(3)
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32, p, p + q))
    got = threefry.uniform(threefry.key(3), shape, p, p + q)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("p,q", PQ[1:3])
def test_uniform_rounds_once_where_two_roundings_differ(p, q):
    """The reference's ``u * (hi - lo) + lo`` is one FMA (jitted or not):
    the two-rounding form disagrees on a share of these draws, the port
    on none."""
    k = jax.random.key(1)
    want = np.asarray(jax.random.uniform(k, (4096,), jnp.float32, p, p + q))
    bits = threefry.random_bits(threefry.key(1), (4096,))
    u = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0).numpy()
    lo, hi = np.float32(p), np.float32(p + q)
    two = np.maximum(lo, (u * (hi - lo)).astype(np.float32) + lo)
    assert (two != want).mean() > 0.05
    got = threefry.uniform(threefry.key(1), (4096,), p, p + q).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_batched_matches_vmap():
    ks = jax.random.split(jax.random.key(4), 5)
    want = np.asarray(jax.vmap(
        lambda x: jax.random.uniform(x, (3, 77), jnp.float32, -1.5, 1.5))(ks))
    got = threefry.uniform(threefry.split(threefry.key(4), 5), (3, 77),
                           -1.5, 1.5)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_mask_draws_of_the_reference_keys():
    """``masks.pair_key`` and the jitted draws of the keyed mask path."""
    from repro.core import masks as jmasks
    from repro.core.types import SecureAggConfig as JSA
    from repro_torch.core import masks as tmasks
    from repro_torch.core.types import SecureAggConfig as TSA

    for a, b, t in [(0, 1, 0), (3, 7, 5), (9, 2, 11)]:
        jk = jmasks.pair_key(JSA(mask_ratio=0.01), a, b, t)
        tk = tmasks.pair_key(TSA(mask_ratio=0.01), a, b, t)
        np.testing.assert_array_equal(tk.numpy(), _data(jk))
        f = jax.jit(lambda k: (
            jax.random.randint(jax.random.split(k)[0], (4, 9), 0, 1001,
                               dtype=jnp.int32),
            jax.random.uniform(jax.random.split(k)[1], (4, 9),
                               minval=-1.0, maxval=1.0)))
        wi, wv = f(jk)
        sub = threefry.split(tk)
        np.testing.assert_array_equal(
            threefry.randint(sub[0], (4, 9), 0, 1001).numpy(), np.asarray(wi))
        np.testing.assert_array_equal(
            threefry.uniform(sub[1], (4, 9), -1.0, 1.0).numpy(),
            np.asarray(wv))
