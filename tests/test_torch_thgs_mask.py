"""Port parity: the THGS threshold split and the dense mask-and-apply pass
(``repro_torch.kernels.ref`` plain versions and the ``ops`` entries) against
the JAX reference's jitted ``repro.kernels.ops.thgs_sparsify`` /
``mask_prng_apply`` (the Pallas kernels in interpret mode), compared as bits
on numpy inputs made from a seed.

Where the port departs from the reference's eager oracles in
``repro.kernels.ref`` it follows the jitted kernels, and each departure has
its test here: the residual of a kept +-inf accumulator is NaN (``acc -
sparse``, as the kernel), and ``p + q * u`` is rounded once, as the jitted
kernel's vectorized loop does (XLA rounds twice in its scalar loops). NaN
payloads are not compared: x86, torch and CUDA produce different ones.

The CUDA kernels themselves run only on a card: the ``gpu``-marked tests hold
each against its plain version there and skip elsewhere.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mask_prng import mask_prng_apply as jmask  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
D32 = np.float32(0.1)           # f32(delta) for delta = 0.1, not f32-exact


def _to_torch(x_jax, name):
    """A JAX array -> the torch tensor of the same bits."""
    return torch.from_numpy(np.array(x_jax.astype(jnp.float32))).to(
        DTYPES[name][1])


def _bits(x):
    """Integer view of a float tensor/array (NaN lanes zeroed: payloads
    differ between platforms) and the NaN mask."""
    x = x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x.astype(jnp.float32))
    nan = np.isnan(x)
    return np.where(nan, 0, x.view(np.int32)), nan


def _assert_bits(a, b, what=""):
    ba, na = _bits(a)
    bb, nb = _bits(b)
    np.testing.assert_array_equal(na, nb, err_msg=f"NaN lanes {what}")
    np.testing.assert_array_equal(ba, bb, err_msg=what)


def _split_case(shape, g_name, r_name, seed):
    """g ~ N(0, 1), r ~ N(0, 0.04), with ties at f32(0.1), +-inf and a -0.0
    accumulator planted in the first lanes."""
    rs = np.random.RandomState(seed)
    n = int(np.prod(shape))
    g = rs.randn(n).astype(np.float32)
    r = (0.2 * rs.randn(n)).astype(np.float32)
    if n >= 8:
        g[:8] = [0.09375, -0.09375, np.inf, -np.inf, -0.0, D32, 2.0, -3.0]
        r[:8] = [D32 - np.float32(0.09375), np.float32(0.09375) - D32, 1.0,
                 -1.0, -0.0, 0.0, 0.5, 0.25]
    jg = jnp.asarray(g.reshape(shape)).astype(DTYPES[g_name][0])
    jr = jnp.asarray(r.reshape(shape)).astype(DTYPES[r_name][0])
    return jg, jr, _to_torch(jg, g_name), _to_torch(jr, r_name)


# ------------------------------------------------------------ thgs_sparsify
@pytest.mark.parametrize("shape", [(100,), (64, 129), (7, 3, 11), (4096,),
                                   (1,)])
@pytest.mark.parametrize("g_name,r_name", [("f32", "f32"), ("bf16", "bf16"),
                                           ("bf16", "f32"), ("f32", "bf16")])
def test_thgs_sparsify_bit_exact_vs_jitted_kernel(shape, g_name, r_name):
    jg, jr, tg, tr = _split_case(shape, g_name, r_name, seed=len(shape))
    js, jres = jops.thgs_sparsify(jg, jr, 0.1)
    for fn in (tref.thgs_sparsify_ref, ops.thgs_sparsify):
        ts, tres = fn(tg, tr, 0.1)
        assert ts.dtype == tg.dtype and tres.dtype == tr.dtype
        assert ts.shape == tg.shape and tres.shape == tr.shape
        _assert_bits(ts, js, "sparse")
        _assert_bits(tres, jres, "residual")
    # the threshold as a one-element tensor gives the same split
    ts, tres = ops.thgs_sparsify(tg, tr, torch.tensor(0.1))
    _assert_bits(ts, js, "sparse, tensor threshold")


def test_thgs_sparsify_compares_against_f32_delta():
    """``|acc| > f32(0.1)``: an accumulator exactly at f32(0.1) (above the
    real 0.1) is not kept; the next f32 up is."""
    up = np.nextafter(D32, np.float32(1))
    g = np.array([D32, -D32, up, -up, 0.0, np.float32(0.0999)], np.float32)
    r = np.zeros_like(g)
    js, jres = jops.thgs_sparsify(jnp.asarray(g), jnp.asarray(r), 0.1)
    ts, tres = ops.thgs_sparsify(torch.from_numpy(g), torch.from_numpy(r),
                                 0.1)
    _assert_bits(ts, js)
    _assert_bits(tres, jres)
    assert ts.tolist() == [0.0, 0.0, float(up), -float(up), 0.0, 0.0]


def test_thgs_sparsify_inf_residual_follows_the_kernel():
    """A kept +-inf accumulator leaves ``acc - sparse`` = NaN in the Pallas
    kernel and in the port; the reference's eager oracle writes 0 there
    (``where(keep, 0, acc)``) — the one place the two reference functions
    differ, and the port follows the kernel."""
    g = np.array([np.inf, -np.inf, 1.0, -0.0], np.float32)
    r = np.array([1.0, -1.0, 0.0, -0.0], np.float32)
    js, jres = jops.thgs_sparsify(jnp.asarray(g), jnp.asarray(r), 0.5)
    _, oracle = jref.thgs_sparsify_ref(jnp.asarray(g), jnp.asarray(r), 0.5)
    ts, tres = ops.thgs_sparsify(torch.from_numpy(g), torch.from_numpy(r),
                                 0.5)
    _assert_bits(ts, js)
    _assert_bits(tres, jres)
    assert np.isnan(tres.numpy()[:2]).all()
    assert (np.asarray(oracle)[:2] == 0.0).all()
    assert np.signbit(tres.numpy()[3])        # -0.0 - (+0.0) stays -0.0


# ---------------------------------------------------------- mask_prng_apply
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("n,block_rows", [(1, 256), (97, 2), (256, 2),
                                          (257, 2), (255, 2),
                                          (50_000, 256)])
def test_mask_prng_apply_bit_exact_padding_and_signs(n, block_rows, sign):
    """Every size of the reference's padding test, both signs: mask and
    output bit-equal to the interpret-mode kernel and the jitted entry —
    the signed zero off the support included (compared as bits)."""
    g = np.random.RandomState(n).randn(n).astype(np.float32)
    jo, jm = jmask(jnp.asarray(g), 77, sigma=-0.2, sign=sign,
                   block_rows=block_rows, interpret=True)
    jo2, jm2 = jops.mask_prng_apply(jnp.asarray(g), seed=77, sigma=-0.2,
                                    sign=sign)
    for fn in (lambda x: tref.mask_prng_ref(x, 77, p=-1.0, q=2.0,
                                            sigma=-0.2, sign=sign),
               lambda x: ops.mask_prng_apply(x, seed=77, sigma=-0.2,
                                             sign=sign)):
        to, tm = fn(torch.from_numpy(g))
        assert tm.dtype == torch.float32 and tm.shape == (n,)
        for a, b in ((tm, jm), (to, jo), (tm, jm2), (to, jo2)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))
    if sign < 0 and n >= 97:
        assert (tm.numpy().view(np.int32) == np.int32(-2**31)).any()


@pytest.mark.parametrize("p,q", [(-1.5, 3.0), (-0.7, 1.3)])
def test_mask_prng_apply_is_one_fma_like_the_jitted_kernel(p, q):
    """At a non-default (p, q) the jitted kernel's vectorized loop rounds
    ``p + q*u`` once (a fused multiply-add); the port matches it bit for bit
    on every lane of a 2^15-element leaf, while the reference's eager oracle
    (product rounded first) differs on many of them."""
    n = 2**15
    g = np.random.RandomState(3).randn(n).astype(np.float32)
    jo, jm = jops.mask_prng_apply(jnp.asarray(g), seed=1234, p=p, q=q,
                                  sigma=10.0)
    to, tm = ops.mask_prng_apply(torch.from_numpy(g), seed=1234, p=p, q=q,
                                 sigma=10.0)
    np.testing.assert_array_equal(tm.numpy().view(np.int32),
                                  np.asarray(jm).view(np.int32))
    np.testing.assert_array_equal(to.numpy().view(np.int32),
                                  np.asarray(jo).view(np.int32))
    _, em = jref.mask_prng_ref(jnp.asarray(g), 1234, p=p, q=q, sigma=10.0)
    assert (np.asarray(em) != np.asarray(jm)).sum() > n // 10


def _f32_nearest(exact: Fraction) -> np.float32:
    """``exact`` rounded to the nearest f32, ties to even."""
    c = np.float32(float(exact))
    cands = (np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.array(v).view(np.int32)) & 1))


@pytest.mark.parametrize("n", [100, 3000])
def test_mask_prng_apply_single_rounding_where_xla_rounds_twice(n):
    """The port rounds ``p + q*u`` once on every lane (checked against exact
    rational arithmetic). The jitted reference does not on every lane:
    XLA's CPU code contracts it into an FMA in its vectorized loop but
    rounds twice in scalar code (small arrays, some loop remainders), so
    each of its lanes is one of the two roundings."""
    p, q = -1.5, 3.0
    g = np.zeros(n, np.float32)
    _, jm = jops.mask_prng_apply(jnp.asarray(g), seed=1234, p=p, q=q,
                                 sigma=10.0)
    _, tm = ops.mask_prng_apply(torch.from_numpy(g), seed=1234, p=p, q=q,
                                sigma=10.0)
    x = tref._mix32(torch.arange(n, dtype=torch.int64) ^ 1234).numpy()
    u = (x.astype(np.float32) / np.float32(2**32)).astype(np.float32)
    p32, q32 = np.float32(p), np.float32(q)
    once = np.array([_f32_nearest(Fraction(float(p32)) + Fraction(float(q32))
                                  * Fraction(float(v))) for v in u])
    twice = (p32 + (q32 * u).astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(tm.numpy().view(np.int32),
                                  once.view(np.int32))
    jm = np.asarray(jm)
    assert ((jm == once) | (jm == twice)).all()
    assert (once != twice).sum() > n // 5


def _unmix32(y: int) -> int:
    m = 2**32
    y ^= y >> 16
    y = y * pow(0x846CA68B, -1, m) % m
    y ^= (y >> 15) ^ (y >> 30)
    y = y * pow(0x7FEB352D, -1, m) % m
    return y ^ (y >> 16)


@pytest.mark.parametrize("x", [2**24 - 1, 2**24 + 1, 2**24 + 3, 2**25 + 2,
                               2**25 + 6, 2**31 + 128, 2**31 + 384,
                               2**32 - 129, 2**32 - 128, 2**32 - 127,
                               2**32 - 3, 2**32 - 1])
def test_mask_prng_apply_uint32_to_f32_rounds_to_nearest_even(x):
    """The 32-bit draw's conversion to f32 rounds to nearest even, as XLA's:
    a seed chosen so that position 3 draws ``x`` (around 2^24 and 2^25
    multiples, odd values near 2^32); 0xFFFFFFFF rounds to 2^32, so
    u = p + q exactly. The default (p, q) makes ``p + q*u`` exact, so the
    jitted reference is compared there."""
    seed = _unmix32(x) ^ 3
    assert int(tref._mix32(torch.tensor([3 ^ seed]))[0]) == x
    g = np.zeros(8, np.float32)
    _, jm = jops.mask_prng_apply(jnp.asarray(g), seed=seed, sigma=10.0)
    _, tm = ops.mask_prng_apply(torch.from_numpy(g), seed=seed, sigma=10.0)
    np.testing.assert_array_equal(tm.numpy().view(np.int32),
                                  np.asarray(jm).view(np.int32))
    # at p = -1.5, q = 3 the exact p + q*u of these draws fits in f64, so
    # rounding it once to f32 is the single-rounding result
    _, tm = ops.mask_prng_apply(torch.from_numpy(g), seed=seed, p=-1.5,
                                q=3.0, sigma=10.0)
    u = np.float32(np.float32(x) / np.float32(2**32))
    assert tm.numpy()[3] == np.float32(-1.5 + 3.0 * np.float64(u))
    if x == 2**32 - 1:
        assert u == 1.0 and tm.numpy()[3] == np.float32(1.5)    # p + q


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_mask_prng_apply_bf16_rounds_once(sign):
    """bf16 g: ``g + mask`` in f32, rounded once to bf16; the mask f32."""
    g32 = np.random.RandomState(5).randn(4096).astype(np.float32)
    jg = jnp.asarray(g32).astype(jnp.bfloat16)
    jo, jm = jops.mask_prng_apply(jg, seed=99, p=-1.5, q=3.0, sigma=0.2,
                                  sign=sign)
    to, tm = ops.mask_prng_apply(_to_torch(jg, "bf16"), seed=99, p=-1.5,
                                 q=3.0, sigma=0.2, sign=sign)
    assert to.dtype == torch.bfloat16 and tm.dtype == torch.float32
    _assert_bits(to, jo)
    np.testing.assert_array_equal(tm.numpy().view(np.int32),
                                  np.asarray(jm).view(np.int32))


def test_ops_lists_seven_kernels_with_counters():
    assert len(ops.KERNELS) == 7
    assert {"thgs_sparsify", "mask_prng_apply"} <= set(ops.KERNELS)
    ops.reset_launch_counts()
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    # the CPU takes the plain versions: no kernel launch is counted
    ops.thgs_sparsify(torch.ones(4), torch.zeros(4), 0.5)
    ops.mask_prng_apply(torch.ones(4), seed=1, sigma=0.0)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_scatter_fold_by_rank_equals_the_cpu_fold():
    """The plain scatter's two folds (numpy's in-order ``add.at`` on the
    CPU, rank passes elsewhere) agree bit for bit, a hot position holding
    most of the stream (the tree decode's dump slot) included."""
    rs = np.random.RandomState(11)
    idx = rs.randint(-1, 60, 5000)
    idx[rs.rand(5000) < 0.6] = 59
    vals = (rs.randn(5000) * np.exp(rs.randn(5000) * 4)).astype(np.float32)
    it, vt = torch.from_numpy(idx), torch.from_numpy(vals)
    cpu = tref.stream_scatter_add_ref(it, vt, 60)
    keep = it >= 0
    by_rank = tref.scatter_fold_by_rank(it[keep], vt[keep], 60)
    np.testing.assert_array_equal(cpu.numpy().view(np.int32),
                                  by_rank.numpy().view(np.int32))
    want = np.asarray(jref.stream_scatter_add_ref(jnp.asarray(idx),
                                                  jnp.asarray(vals), 60))
    np.testing.assert_array_equal(cpu.numpy().view(np.int32),
                                  want.view(np.int32))


# ------------------------------------------------------------ on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "with no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_thgs_sparsify_bit_equal_to_plain_version():
    dev = _cuda()
    ops.reset_launch_counts()
    cases = 0
    for n in (2359296, 156800, 1, 97, 255, 257, 50000):
        for g_name, r_name in (("f32", "f32"), ("bf16", "bf16"),
                               ("bf16", "f32"), ("f32", "bf16")):
            _, _, tg, tr = _split_case((n,), g_name, r_name, seed=n % 101)
            tg, tr = tg.to(dev), tr.to(dev)
            for thr in (0.1, torch.tensor(0.1, device=dev)):
                ks, kr = ops.thgs_sparsify(tg, tr, thr)
                ps, pr = tref.thgs_sparsify_ref(tg, tr, 0.1)
                torch.cuda.synchronize()
                _assert_bits(ks.cpu(), ps.cpu(), f"{n} {g_name}/{r_name}")
                _assert_bits(kr.cpu(), pr.cpu(), f"{n} {g_name}/{r_name}")
                cases += 1
    assert ops.launch_counts()["thgs_sparsify"] == cases


@pytest.mark.gpu
def test_cuda_mask_prng_apply_bit_equal_to_plain_version():
    dev = _cuda()
    ops.reset_launch_counts()
    cases = 0
    for n in (2359296, 156800, 1, 97, 255, 257, 50000):
        g = torch.from_numpy(np.random.RandomState(n % 89).randn(n).astype(
            np.float32)).to(dev)
        for gd in (torch.float32, torch.bfloat16):
            for p, q in ((-1.0, 2.0), (-1.5, 3.0), (-0.7, 1.3)):
                for sign in (1.0, -1.0):
                    ko, km = ops.mask_prng_apply(g.to(gd), seed=n, p=p, q=q,
                                                 sigma=p + 0.3 * q, sign=sign)
                    po, pm = tref.mask_prng_ref(g.to(gd), n, p=p, q=q,
                                                sigma=p + 0.3 * q, sign=sign)
                    torch.cuda.synchronize()
                    assert torch.equal(km.view(torch.int32),
                                       pm.view(torch.int32))
                    _assert_bits(ko.cpu(), po.cpu(), f"{n} {gd} {p} {q}")
                    cases += 1
    assert ops.launch_counts()["mask_prng_apply"] == cases
