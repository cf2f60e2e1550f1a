"""Port parity: the kernels' plain versions (``repro_torch.kernels.ref``) and
the device dispatch (``repro_torch.kernels.ops``) against the JAX reference's
oracles, bit for bit. The CUDA kernels themselves run only on a card: the
``gpu``-marked test holds each against its plain version there and skips
elsewhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SEEDS_EDGE = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1,
                       0xDEADBEEF, 0x9E3779B9 ^ 0xFFFFFFFF], np.uint32)


def _seeds(n, seed):
    rs = np.random.RandomState(seed)
    return np.concatenate([SEEDS_EDGE,
                           rs.randint(0, 2**32, n, dtype=np.uint64)
                           .astype(np.uint32)])


def _u32(t):
    return np.asarray(t.numpy(), np.int64).astype(np.uint32)


def test_mix32_bit_exact_full_range():
    x = _seeds(4096, 0)
    want = np.asarray(jref._mix32(jnp.asarray(x)))
    got = _u32(tref._mix32(torch.from_numpy(x.astype(np.int64))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("leaf_id", [0, 1, 7, 30, 2**31 - 1])
def test_fold_leaf_seed_bit_exact(leaf_id):
    x = _seeds(256, leaf_id % 97)
    want = np.asarray(jref.fold_leaf_seed(jnp.asarray(x), leaf_id))
    got = _u32(tref.fold_leaf_seed(torch.from_numpy(x.astype(np.int64)),
                                   leaf_id))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb,k_mask,m", [
    (1, 313, 156800),      # the main path's l0.w shape
    (3, 7, 1001),          # odd nb*k_mask, m not a power of two
    (2, 5, 13),            # tiny m: heavy mod-m collisions
    (1, 1, 1),
])
def test_pair_mask_stream_ref_bit_exact(nb, k_mask, m):
    seeds = _seeds(9, nb * 31 + k_mask)
    signs = np.resize(np.array([1.0, -1.0, 0.0], np.float32), len(seeds))
    ji, jv = jref.pair_mask_stream_ref(jnp.asarray(seeds), jnp.asarray(signs),
                                       nb, k_mask, m, p=-1.0, q=2.0)
    ti, tv = tref.pair_mask_stream_ref(
        torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(signs),
        nb, k_mask, m, p=-1.0, q=2.0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


def _unmix32(y: int) -> int:
    """Inverse of the murmur finalizer (a bijection on uint32)."""
    m = 2**32
    y ^= y >> 16
    y = y * pow(0x846CA68B, -1, m) % m
    y ^= (y >> 15) ^ (y >> 30)
    y = y * pow(0x7FEB352D, -1, m) % m
    return y ^ (y >> 16)


def test_pair_mask_counter_wraps_past_2_32():
    """``base + c`` wraps mod 2^32: seeds whose IDX and VAL bases sit just
    below 2^32, so both counter streams cross the wrap inside the stream."""
    near = np.array([_unmix32(2**32 - 5) ^ jref.IDX_SALT,
                     _unmix32(2**32 - 1) ^ jref.VAL_SALT,
                     _unmix32(2**32 - 100) ^ jref.VAL_SALT], np.uint32)
    base_i = np.asarray(jref._mix32(jnp.asarray(near ^ np.uint32(
        jref.IDX_SALT))))
    assert base_i[0] == 2**32 - 5
    ji, jv = jref.pair_mask_stream_ref(jnp.asarray(near),
                                       jnp.ones(len(near), jnp.float32),
                                       2, 64, 977, p=-1.0, q=2.0)
    ti, tv = tref.pair_mask_stream_ref(torch.from_numpy(near.astype(np.int64)),
                                       torch.ones(len(near)), 2, 64, 977,
                                       p=-1.0, q=2.0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pair_mask_general_p_q_two_roundings():
    seeds = _seeds(16, 11)
    for p, q in ((-0.3, 0.7), (0.1, 3.3)):
        _, jv = jref.pair_mask_stream_ref(jnp.asarray(seeds),
                                          jnp.ones(len(seeds), jnp.float32),
                                          1, 33, 100, p=p, q=q)
        _, tv = tref.pair_mask_stream_ref(
            torch.from_numpy(seeds.astype(np.int64)), torch.ones(len(seeds)),
            1, 33, 100, p=p, q=q)
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      np.asarray(jv).view(np.int32))


def _scatter_case(n, size, seed):
    rs = np.random.RandomState(seed)
    idx = rs.randint(-2, size + 3, n).astype(np.int32)   # -1/-2 and >= size
    vals = (rs.randint(-2**23, 2**23, n) / 2.0**23
            + rs.randn(n) * 1e-3).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("n,size,seed", [(1, 1, 0), (97, 10, 1),
                                         (5000, 300, 2), (3000, 4099, 3)])
def test_stream_scatter_add_ref_bit_exact(n, size, seed):
    idx, vals = _scatter_case(n, size, seed)
    want = np.asarray(jref.stream_scatter_add_ref(jnp.asarray(idx),
                                                  jnp.asarray(vals), size))
    got = tref.stream_scatter_add_ref(torch.from_numpy(idx),
                                      torch.from_numpy(vals), size).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_stream_scatter_add_order_and_signed_zero():
    """The fold is in slot order from +0.0: [1, 2^-24, -1] gives 0.0 and
    [1, -1, 2^-24] gives 2^-24; a lone -0.0 and an exact cancellation give
    +0.0 — all as the reference's scatter on the CPU."""
    e = 2.0 ** -24
    idx = np.array([4, 4, 4, 7, 7, 7, 2, 5, 5, -1, 9, 0], np.int32)
    vals = np.array([1, e, -1, 1, -1, e, -0.0, 0.75, -0.75, 5, 5, -0.0],
                    np.float32)
    want = np.asarray(jref.stream_scatter_add_ref(jnp.asarray(idx),
                                                  jnp.asarray(vals), 9))
    got = tref.stream_scatter_add_ref(torch.from_numpy(idx),
                                      torch.from_numpy(vals), 9).numpy()
    assert got[4] == 0.0 and got[7] == np.float32(e)
    assert not np.signbit(got[2]) and not np.signbit(got[0])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_stream_scatter_add_order_sensitive_at_large_n():
    """A large stream (past the sizes where PyTorch's CPU accumulate goes
    parallel) with order-sensitive triples at several positions."""
    n, size = 200_000, 5000
    idx, vals = _scatter_case(n, size, 7)
    e = 2.0 ** -24
    for j, p in enumerate((11, 2222, 4999)):
        idx[idx == p] = (p + 1) % size
        slots = np.array([10, 90_000, 199_990]) + j
        idx[slots], vals[slots] = p, np.array([1.0, e, -1.0], np.float32)
    want = np.asarray(jref.stream_scatter_add_ref(jnp.asarray(idx),
                                                  jnp.asarray(vals), size))
    got = tref.stream_scatter_add_ref(torch.from_numpy(idx),
                                      torch.from_numpy(vals), size).numpy()
    assert got[11] == got[2222] == got[4999] == 0.0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_ops_dispatch_by_device_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    ops.reset_launch_counts()
    idx, vals = _scatter_case(500, 77, 9)
    out = ops.stream_scatter_add(torch.from_numpy(idx),
                                 torch.from_numpy(vals), size=77)
    np.testing.assert_array_equal(
        out.numpy(), tref.stream_scatter_add_ref(
            torch.from_numpy(idx), torch.from_numpy(vals), 77).numpy())
    seeds = torch.from_numpy(_seeds(3, 1).astype(np.int64))
    i1, v1 = ops.pair_mask_streams(seeds, torch.ones(len(seeds)), nb=1,
                                   k_mask=5, m=77)
    i2, v2 = tref.pair_mask_stream_ref(seeds, torch.ones(len(seeds)), 1, 5,
                                       77, p=-1.0, q=2.0)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    assert ops.launch_counts() == {"stream_scatter_add": 0,
                                   "pair_mask_streams": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import mask_prng, stream_decode

    with pytest.raises(ValueError):
        stream_decode.stream_scatter_add_cuda(torch.zeros(3, dtype=torch.int32),
                                              torch.zeros(3), 4)
    with pytest.raises(ValueError):
        mask_prng.pair_mask_streams_cuda(torch.zeros(3, dtype=torch.int64),
                                         torch.ones(3), nb=1, k_mask=2, m=5)


@pytest.mark.gpu
def test_cuda_kernels_bit_equal_to_plain_versions():
    """On the card: both CUDA kernels equal their plain versions bit for bit,
    the scatter is deterministic and folds in slot order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "with no CPU mode")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    for n, size, seed in ((47225, 156800, 1), (5000, 300, 2)):
        idx, vals = _scatter_case(n, size, seed)
        idx[idx == 17] = 18
        idx[[3, n // 2, n - 2]] = 17
        vals[[3, n // 2, n - 2]] = [1.0, 2.0 ** -24, -1.0]
        it, vt = torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)
        a = ops.stream_scatter_add(it, vt, size=size)
        b = ops.stream_scatter_add(it, vt, size=size)
        plain = tref.stream_scatter_add_ref(it, vt, size)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), plain.view(torch.int32))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert a[17].item() == 0.0
    seeds = torch.from_numpy(_seeds(7, 5).astype(np.int64)).to(dev)
    signs = torch.ones(len(seeds), device=dev)
    ki, kv = ops.pair_mask_streams(seeds, signs, nb=2, k_mask=313, m=156800)
    pi, pv = tref.pair_mask_stream_ref(seeds, signs, 2, 313, 156800,
                                       p=-1.0, q=2.0)
    assert torch.equal(ki, pi) and torch.equal(kv.view(torch.int32),
                                               pv.view(torch.int32))
    assert ops.launch_counts() == {"stream_scatter_add": 4,
                                   "pair_mask_streams": 1}
