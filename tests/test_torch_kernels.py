"""Port parity: the kernels' plain versions (``repro_torch.kernels.ref``) and
the device dispatch (``repro_torch.kernels.ops``) against the JAX reference's
oracles, bit for bit. The CUDA kernels themselves run only on a card: the
``gpu``-marked test holds each against its plain version there and skips
elsewhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

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
    u = torch.from_numpy(_fields(3, 45, 11, 4))
    w1 = ops.bitpack_rows(u, width=11)
    assert torch.equal(w1, tref.bitpack_rows_ref(u, 11))
    assert torch.equal(ops.bitunpack_rows(w1, k=45, width=11), u)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import mask_prng, pack, stream_decode

    with pytest.raises(ValueError):
        stream_decode.stream_scatter_add_cuda(torch.zeros(3, dtype=torch.int32),
                                              torch.zeros(3), 4)
    with pytest.raises(ValueError):
        mask_prng.pair_mask_streams_cuda(torch.zeros(3, dtype=torch.int64),
                                         torch.ones(3), nb=1, k_mask=2, m=5)
    with pytest.raises(ValueError):
        pack.bitpack_rows_cuda(torch.zeros(2, 3, dtype=torch.int64), 5)
    with pytest.raises(ValueError):
        pack.bitunpack_rows_cuda(torch.zeros(2, 3, dtype=torch.int64), 4, 5)


def _fields(R, k, width, seed):
    """uint32 fields below 2**width as int64, with the extremes 0 and
    2**width - 1 in the first row."""
    rs = np.random.RandomState(seed)
    u = rs.randint(0, 2**32, (R, k), dtype=np.uint64) >> np.uint64(
        32 - width)
    u[0, :2] = [0, 2**width - 1]
    return u.astype(np.int64)


# every width 1..32 at an odd k that spans several 32-slot chunks, then the
# index widths the main path uses (mnist_mlp leaves of 10, 200, 2,000 and
# 156,800 elements; VGG16's 2,359,296) at their shapes, cut in k
PACK_CASES = ([(3, 75, w) for w in range(1, 33)]
              + [(5, 40, 4), (5, 63, 8), (5, 97, 11), (5, 7880, 18),
                 (2, 2049, 22), (5, 7880, 8), (4, 1000, 1)])


@pytest.mark.parametrize("R,k,width", PACK_CASES,
                         ids=[f"w{w}-k{k}" for _, k, w in PACK_CASES])
def test_bitpack_rows_bit_exact_with_reference(R, k, width):
    """The plain versions equal the reference's ref twins, both ways, for
    every width, and its Pallas kernels (interpret mode, a compile per
    width) at the widths the main path uses and the extremes."""
    from repro.kernels import pack as jpack

    u = _fields(R, k, width, seed=width * 1000 + k)
    ju = jnp.asarray(u.astype(np.uint32))
    want = np.asarray(jref.bitpack_rows_ref(ju, width))
    pallas = width in (1, 2, 4, 8, 11, 18, 22, 31, 32)
    if pallas:
        np.testing.assert_array_equal(
            np.asarray(jpack.bitpack_rows(ju, width, interpret=True)), want)
    got = tref.bitpack_rows_ref(torch.from_numpy(u), width)
    assert got.shape == (R, tref.packed_words(k, width)) == want.shape
    assert tref.packed_words(k, width) == jref.packed_words(k, width)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    back = tref.bitunpack_rows_ref(torch.from_numpy(want.astype(np.int64)),
                                   k, width)
    np.testing.assert_array_equal(back.numpy(), u)
    jback = (jpack.bitunpack_rows(jnp.asarray(want), k, width,
                                  interpret=True) if pallas
             else jref.bitunpack_rows_ref(jnp.asarray(want), k, width))
    np.testing.assert_array_equal(np.asarray(jback), u.astype(np.uint32))


def test_bitpack_rows_ref_layout_and_high_bits():
    """Field s sits at bits [s*w, s*w + w) of the row, LSB first; only the
    low ``width`` bits of a field are taken; padding bits are zero."""
    u = torch.tensor([[0b101, 0b011, 0b111, 0b001, 0b110]])
    w = tref.bitpack_rows_ref(u, 3)
    assert w.tolist() == [[0b110_001_111_011_101]]
    assert torch.equal(tref.bitpack_rows_ref(u | (1 << 20), 3), w)
    assert tref.bitpack_rows_ref(torch.tensor([[2**32 - 1]]), 32).tolist() \
        == [[2**32 - 1]]
    with pytest.raises(ValueError):
        tref.bitpack_rows_ref(u, 33)


@pytest.mark.gpu
def test_cuda_kernels_bit_equal_to_plain_versions():
    """On the card: both CUDA kernels equal their plain versions bit for bit,
    the scatter is deterministic and folds in slot order, also on a stream
    all in one tile, at a position with 12,000 non-zero entries, on a tree
    group's dump-slot buffer and on an all-zero stream; one launch counted
    per scatter call. The pair-mask kernel's round launch over mnist_mlp's
    4 and VGG16's 54 leaves, masks and recovery streams, is one launch each
    and bit-equal to its plain version and to the per-leaf flat calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "with no CPU mode")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    cases = []
    for n, size, seed in ((47225, 156800, 1), (5000, 300, 2)):
        idx, vals = _scatter_case(n, size, seed)
        idx[idx == 17] = 18
        idx[[3, n // 2, n - 2]] = 17
        vals[[3, n // 2, n - 2]] = [1.0, 2.0 ** -24, -1.0]
        cases.append((idx, vals, size, True))
    rs = np.random.RandomState(3)
    idx, vals = _scatter_case(100_000, 200, 3)          # one tile
    cases.append((idx, vals, 156800, False))
    idx, vals = _scatter_case(60_000, 50_000, 4)        # the serial owner
    hot = rs.choice(60_000, 12_000, replace=False)
    idx[hot] = 777
    vals[hot] = rs.randn(12_000) * np.exp2(rs.randint(-20, 20, 12_000))
    cases.append((idx, vals, 50_000, False))
    idx, vals = _scatter_case(56_676, 156_800, 5)       # a tree group
    inside = (idx >= 52_267) & (idx < 104_534)
    cases.append((np.where(inside, idx - 52_267, 52_267).astype(np.int32),
                  np.where(inside, vals, 0.0).astype(np.float32), 52_268,
                  False))
    idx, _ = _scatter_case(9000, 997, 6)                # zeros only
    cases.append((idx, np.where(rs.rand(9000) < 0.5, 0.0, -0.0)
                  .astype(np.float32), 997, False))
    for idx, vals, size, triple in cases:
        it, vt = torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)
        a = ops.stream_scatter_add(it, vt, size=size)
        b = ops.stream_scatter_add(it, vt, size=size)
        plain = tref.stream_scatter_add_ref(it, vt, size)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), plain.view(torch.int32))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if triple:
            assert a[17].item() == 0.0
    assert not torch.signbit(a).any()
    seeds = torch.from_numpy(_seeds(7, 5).astype(np.int64)).to(dev)
    signs = torch.ones(len(seeds), device=dev)
    ki, kv = ops.pair_mask_streams(seeds, signs, nb=2, k_mask=313, m=156800)
    pi, pv = tref.pair_mask_stream_ref(seeds, signs, 2, 313, 156800,
                                       p=-1.0, q=2.0)
    assert torch.equal(ki, pi) and torch.equal(kv.view(torch.int32),
                                               pv.view(torch.int32))
    counts = ops.launch_counts()
    assert (counts["stream_scatter_add"], counts["pair_mask_streams"]) == \
        (2 * len(cases), 1)
    # the round launch: every leaf of a mnist_mlp round (4) and of a VGG16
    # round (54), and their recovery streams, one launch each, bit-equal to
    # the segmented plain version and to the per-leaf flat launches
    from repro_torch.core import streams as tse
    from repro_torch.models.paper_models import build_model

    C = 5
    rs = np.random.RandomState(6)
    s = np.triu(rs.randint(0, 2**32, (C, C), dtype=np.uint64)
                .astype(np.int64), 1)
    s[0, 4] = 2**32 - 1
    s = s + s.T
    g = np.triu(rs.choice([-1.0, 1.0], (C, C)), 1).astype(np.float32)
    g = g - g.T
    g[1, 3] = g[3, 1] = 0.0
    alive = np.array([True, False, True, True, False])
    rec = np.where(alive[:, None] != alive[None, :], s, 0)
    seeds, sg = tse.round_matrices(dev, torch.from_numpy(s),
                                   torch.from_numpy(g))
    rseeds, al = tse.round_matrices(dev, torch.from_numpy(rec),
                                    torch.from_numpy(alive))
    with torch.device("meta"):
        vgg = [x.numel() for x in build_model(
            "cifar_vgg16", device="meta").params().values()]
    for sizes in ([156800, 200, 2000, 10], vgg):
        leaves = [(1, max(1, int(n * 0.01 / C)), n, leaf)
                  for leaf, n in enumerate(sizes)]
        ops.reset_launch_counts()
        got = tse.mask_streams_round(seeds, sg, leaves, p=-1.0, q=2.0)
        rgot = tse.recovery_streams_round(rseeds, sg, al, leaves, p=-1.0,
                                          q=2.0)
        assert ops.launch_counts()["pair_mask_streams"] == 2
        plain = tref.pair_mask_segments_ref(seeds, sg, leaves, mirror=True)
        rplain = tref.pair_mask_segments_ref(rseeds, sg, leaves, alive=al)
        for (nb, km, m, leaf), (i, v), (pi_, pv_), r, (ri, rv) in zip(
                leaves, got, plain, rgot, rplain):
            fi, fv = tse.mask_streams_all_pairs(seeds, sg, nb, km, m, p=-1.0,
                                                q=2.0, leaf_id=leaf)
            fr = tse.dropout_cancel_streams_seeded(rseeds, sg, al, nb, km, m,
                                                   p=-1.0, q=2.0,
                                                   leaf_id=leaf)
            for a_, b_ in ((i, pi_), (i, fi), (r.indices, ri),
                           (r.indices, fr.indices)):
                assert torch.equal(a_, b_)
            for a_, b_ in ((v, pv_), (v, fv), (r.values, rv),
                           (r.values, fr.values)):
                assert torch.equal(a_.view(torch.int32), b_.view(torch.int32))


@pytest.mark.gpu
def test_cuda_pack_kernels_bit_equal_to_plain_versions():
    """On the card: both bit-pack kernels equal their plain versions bit for
    bit, at every width and at the main path's and VGG16's shapes, and
    round-trip; each wrapper call launches once, and so does each
    segmented call over a leaf's two wire streams (18 + 8 and 22 + 1
    bits, int32 lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "with no CPU mode")
    dev = torch.device("cuda")
    cases = [(3, 75, w) for w in range(1, 33)] + [
        (5, 7880, 18), (5, 7880, 8), (5, 60199, 22), (5, 60199, 1)]
    ops.reset_launch_counts()
    for R, k, width in cases:
        u = torch.from_numpy(_fields(R, k, width, seed=width + k)).to(dev)
        words = ops.bitpack_rows(u, width=width)
        plain = tref.bitpack_rows_ref(u, width)
        back = ops.bitunpack_rows(words, k=k, width=width)
        torch.cuda.synchronize()
        assert torch.equal(words, plain), (R, k, width)
        assert torch.equal(back, tref.bitunpack_rows_ref(plain, k, width))
        assert torch.equal(back, u)
    counts = ops.launch_counts()
    assert counts["bitpack_rows"] == counts["bitunpack_rows"] == len(cases)
    for R, k, wi, wv in ((5, 7880, 18, 8), (5, 60199, 22, 1)):
        fields = [torch.from_numpy(_fields(R, k, w, seed=w + k)).to(dev)
                  for w in (wi, wv)]
        lanes = [tref.i32_lanes(u) for u in fields]
        ops.reset_launch_counts()
        words = ops.bitpack_segments(lanes, widths=[wi, wv])
        back = ops.bitunpack_segments(words, ks=[k, k], widths=[wi, wv])
        torch.cuda.synchronize()
        assert ops.launch_counts()["bitpack_rows"] == 1
        assert ops.launch_counts()["bitunpack_rows"] == 1
        for x, y, u, lane, w in zip(words, back, fields, lanes, (wi, wv)):
            assert x.dtype == y.dtype == torch.int32
            assert torch.equal(x, tref.i32_lanes(tref.bitpack_rows_ref(u, w)))
            assert torch.equal(y, lane)


# the shapes chip_smoke.py holds the flash kernel to: (B, T, Hq, Hkv, hd,
# dtype, causal, window[, S]) — Yi-6B's prefill, a long prompt, f32, ragged
# tails, MQA, a sliding window, and a window that ends before the keys; then
# the bf16 (tensor-core) instances at hd 64, without the causal mask, with
# T > S and rows that have no key, with T and S not multiples of 128 (also
# T != S), and with a window at hd 64
FLASH_CASES = [
    (4, 1024, 32, 4, 128, torch.bfloat16, True, None),
    (1, 4096, 32, 4, 128, torch.bfloat16, True, None),
    (2, 256, 8, 2, 64, torch.float32, True, None),
    (2, 24, 32, 4, 128, torch.bfloat16, True, None),
    (1, 1000, 8, 2, 64, torch.float32, True, None),
    (2, 200, 8, 1, 128, torch.bfloat16, True, None),
    (1, 1000, 32, 4, 128, torch.bfloat16, True, 256),
    (1, 300, 4, 2, 64, torch.float32, False, 64),
    (1, 130, 4, 4, 64, torch.float32, False, None),
    (2, 512, 8, 2, 64, torch.bfloat16, True, None),
    (2, 384, 8, 2, 128, torch.bfloat16, False, None),
    (1, 100, 4, 2, 64, torch.bfloat16, True, 8, 40),
    (2, 333, 8, 2, 128, torch.bfloat16, True, None),
    (1, 700, 8, 2, 128, torch.bfloat16, False, None, 333),
    (1, 700, 8, 2, 64, torch.bfloat16, False, 256),
]


def flash_inputs(B, T, H, Hkv, hd, dtype, seed, S=None):
    rs = np.random.RandomState(seed)
    S = T if S is None else S
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
            for shape in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


@pytest.mark.gpu
def test_cuda_flash_attention_close_to_plain_version():
    """On the card: the flash kernel against its plain version at the
    serving path's shapes, within 2e-5 (f32) / 2e-2 (bf16: one rounding of
    the output), one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a "
                    "with no CPU mode")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    cases = FLASH_CASES + [(1, 100, 4, 2, 64, torch.float32, True, 8, 40)]
    for i, case in enumerate(cases):
        B, T, H, Hkv, hd, dtype, causal, window = case[:8]
        S = case[8] if len(case) > 8 else None      # T > S: rows with no key
        q, k, v = (x.to(dev) for x in flash_inputs(B, T, H, Hkv, hd, dtype,
                                                    seed=i, S=S))
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = tref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{case}: {m}")
    assert ops.launch_counts()["flash_attention"] == len(cases)


# (T, S, hd, causal, window, needle): V holds 1000.0 at a key the checked
# rows must not see — a future key, a key just outside the window, or the
# memory past S of a B = 1 view (no row may read it)
FLASH_NEEDLES = [
    (256, 256, 128, True, None, 200),
    (1000, 1000, 128, True, 256, 300),
    (300, 300, 64, False, None, "pad"),
]


@pytest.mark.gpu
def test_cuda_flash_attention_needles_stay_unseen():
    """On the card, bf16: a key that a row must not see holds 1000.0, so a
    mask, tile-skip or tensor-map fault errs by hundreds; the rows blind to
    it stay within 2e-2 of the plain version, and so does every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a "
                    "with no CPU mode")
    dev = torch.device("cuda")
    for i, (T, S, hd, causal, window, needle) in enumerate(FLASH_NEEDLES):
        pad = 128 if needle == "pad" else 0
        q, k, v = flash_inputs(1, T, 8, 2, hd, torch.bfloat16, seed=50 + i,
                               S=S + pad)
        q, k, v = q.to(dev), k.to(dev), v.to(dev)
        pos = torch.arange(T, device=dev)
        if needle == "pad":
            k[:, S:], v[:, S:] = 30.0, 1000.0
            k, v = k[:, :S], v[:, :S]            # a prefix: no copy is made
            blind = torch.ones(T, dtype=torch.bool, device=dev)
        else:
            v[:, needle] = 1000.0
            blind = (needle > pos) if causal else torch.zeros_like(pos) > 0
            if window is not None:
                blind |= needle <= pos - window
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = tref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        assert blind.any()
        torch.testing.assert_close(out[:, blind].float(),
                                   plain[:, blind].float(), rtol=2e-2,
                                   atol=2e-2, msg=lambda m: f"{needle}: {m}")
        torch.testing.assert_close(out.float(), plain.float(), rtol=2e-2,
                                   atol=2e-2, msg=lambda m: f"{needle}: {m}")


# (B, T, S, H, Hkv, hd, dtype, causal, window, needle): the head widths of
# HuBERT-XLarge (80) and Zamba2-7B's shared block (112), which the bf16
# kernel runs with P V padded to 128 (TMA zero-fills V's columns past hd)
FLASH_WIDTH_CASES = [
    (4, 1024, 1024, 16, 16, 80, torch.bfloat16, False, None, None),
    (2, 1024, 1024, 32, 32, 112, torch.bfloat16, True, None, None),
    (2, 256, 256, 8, 8, 80, torch.float32, False, None, None),
    (2, 256, 256, 8, 8, 112, torch.float32, True, None, None),
    (2, 24, 24, 16, 16, 80, torch.bfloat16, False, None, None),
    (1, 333, 333, 32, 32, 112, torch.bfloat16, True, None, None),
    (1, 1000, 1000, 8, 8, 80, torch.bfloat16, True, 256, 300),
    (1, 256, 256, 8, 8, 112, torch.bfloat16, True, None, 200),
    (1, 300, 300, 8, 8, 80, torch.bfloat16, False, None, "pad"),
]


@pytest.mark.gpu
def test_cuda_flash_attention_head_widths_80_and_112():
    """On the card: the kernel at hd 80 and 112 (bf16 and f32, ragged
    lengths, needles at a future key, outside the window and past S) within
    2e-2 (bf16) / 2e-5 (f32) of its plain version, one launch a call; no
    width falls back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a "
                    "with no CPU mode")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    for i, (B, T, S, H, Hkv, hd, dtype, causal, window, needle) in (
            enumerate(FLASH_WIDTH_CASES)):
        pad = 128 if needle == "pad" else 0
        q, k, v = (x.to(dev) for x in flash_inputs(B, T, H, Hkv, hd, dtype,
                                                    seed=70 + i, S=S + pad))
        pos = torch.arange(T, device=dev)
        blind = None
        if needle == "pad":
            k[:, S:], v[:, S:] = 30.0, 1000.0
            k, v = k[:, :S], v[:, :S]            # a prefix: no copy is made
            blind = torch.ones(T, dtype=torch.bool, device=dev)
        elif needle is not None:
            v[:, needle] = 1000.0
            blind = needle > pos
            if window is not None:
                blind |= needle <= pos - window
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = tref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{hd}: {m}")
        if blind is not None:
            assert blind.any()
            torch.testing.assert_close(out[:, blind].float(),
                                       plain[:, blind].float(), rtol=tol,
                                       atol=tol)
    assert ops.launch_counts()["flash_attention"] == len(FLASH_WIDTH_CASES)
