"""Port parity: the round launch of the pair-mask kernel
(``csrc/pair_mask_streams.cu``: every leaf's pair masks of a round, and in a
dropout round every leaf's recovery streams, one launch per 64 leaves).

The kernel runs only on a card, so its decomposition is emulated here in
numpy -- the wrapper's aligned leaf offsets and 64-segment launches, the
segment table and its binary search, 1,024-slot tiles, 4-slot groups
stepped by carries, the per-pair base words in shared memory (or per
thread above 1,024 pairs), the mirror, the leaf fold and the recovery gate
-- and held bit for bit against the JAX reference's ``mask_streams_all_pairs``
and ``dropout_cancel_streams_seeded`` (jitted; the Pallas kernel in
interpret mode for the flat per-pair call). ``mask_streams_round`` /
``recovery_streams_round`` and the segmented plain version are held against
the same, and two rounds of ``secagg_quick`` and ``tree_quick`` through
``run_round`` are bit-identical with the round's precomputed masks and with
the per-leaf path."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import streams as jse  # noqa: E402
from repro.kernels import mask_prng as jmask  # noqa: E402
from repro_torch.core import streams as tse  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

U32 = np.uint32
IDX_SALT, VAL_SALT, LEAF_SALT = U32(0x9E3779B9), U32(0x85EBCA6B), \
    U32(0xA511E9B3)
THREADS, MAX_SEGMENTS, MAX_TABLE = 256, 64, 1024
# the kernel's two instances: slots a thread (a tile is 256 times that) and
# whether the per-pair words go through shared memory; the launcher takes
# the large one above one wave of one-slot CTAs (8 CTAs of 256 threads on
# each of the H100's 132 SMs)
INSTANCES = {"small": (1, False), "large": (4, True)}
ONE_WAVE = THREADS * 8 * 132
P, Q = -1.0, 2.0

# leaf sizes of the paper models, in leaf order
MNIST_SIZES = [156800, 200, 2000, 10]
with torch.device("meta"):
    from repro_torch.models.paper_models import build_model

    VGG16_SIZES = [p.numel() for p in build_model(
        "cifar_vgg16", device="meta").params().values()]


def _mix32(x):
    x = np.asarray(x, U32)
    with np.errstate(over="ignore"):          # uint32 products wrap
        x = x ^ (x >> U32(16))
        x = x * U32(0x7FEB352D)
        x = x ^ (x >> U32(15))
        x = x * U32(0x846CA68B)
        return x ^ (x >> U32(16))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(got, want):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


# ------------------------------------------------ the kernel, in numpy
def _kernel(seeds, signs, alive, flags, segs, ibuf, vbuf, instance):
    """One launch: every CTA of the grid, 256 threads of 1 or 4 slots."""
    PER_THREAD, use_table = INSTANCES[instance]
    TILE = THREADS * PER_THREAD
    rows, peers = seeds.shape
    mirror, gate, glob, pair_major = (bool(flags & f) for f in (1, 2, 4, 8))
    n_pairs = rows * peers
    tile0 = [s["tile0"] for s in segs]
    n_tiles = segs[-1]["tile0"] + -(-segs[-1]["n"] // TILE)

    def words(sg, i, j):
        a, b = (np.minimum(i, j), np.maximum(i, j)) if mirror else (i, j)
        s = seeds[a, b]
        if sg["fold"]:
            s = _mix32(s ^ sg["leaf_key"])
        g = np.zeros(np.shape(i), np.float32)
        if gate:
            g = -(alive[i] * (np.float32(1.0) - alive[j]))
        return (_mix32(s ^ IDX_SALT), _mix32(s ^ VAL_SALT), signs[i, j], g)

    for blk in range(n_tiles):
        lo, hi = 0, len(segs) - 1                 # the kernel's search
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if tile0[mid] <= blk else (lo, mid - 1)
        sg = segs[lo]
        table = None
        if use_table and n_pairs <= MAX_TABLE:    # shared memory
            qq = np.arange(n_pairs)
            table = words(sg, qq // peers, qq % peers)
        k, nb, n = sg["k"], sg["nb"], sg["n"]
        g0 = (blk - sg["tile0"]) * TILE + PER_THREAD * np.arange(THREADS)
        live = g0 < n
        g0 = g0[live]
        if not len(g0):
            continue
        t, rest = g0 % k, g0 // k
        if pair_major:
            b, rest = rest % nb, rest // nb
            j, i = rest % peers, rest // peers
        else:
            j, rest = rest % peers, rest // peers
            b, i = rest % nb, rest // nb

        def load(i, j):
            if table is not None:
                qi = np.minimum(i, rows - 1) * peers + j
                return tuple(x[qi] for x in table)
            return words(sg, np.minimum(i, rows - 1), j)

        bi, bv, sign, gt = load(i, j)
        for e in range(PER_THREAD):
            ok = g0 + e < n
            c = (b * k + t).astype(U32)
            idx = _mix32(bi + c) % U32(sg["m"])
            if glob:
                idx = idx + (b * sg["m"]).astype(U32)
            u = (_mix32(bv + c) >> U32(8)).astype(np.float32) \
                * np.float32(2.0 ** -24)
            v = sign * (np.float32(P) + np.float32(Q) * u)
            if gate:
                v = gt * v
            # the 16-byte stores of a full group and the scalar stores of
            # the ragged edge write the same slots
            out = sg["off"] + g0[ok] + e
            ibuf[out] = idx[ok].view(np.int32)
            vbuf[out] = v[ok]
            if e + 1 == PER_THREAD:
                break
            t = t + 1
            wrap = t == k
            t[wrap] = 0
            if pair_major:
                b = b + wrap
                wb = b == nb
                b[wb] = 0
                j = j + wb
                wj = j == peers
                j[wj] = 0
                i = i + wj
                new = wb
            else:
                j = j + wrap
                wj = j == peers
                j[wj] = 0
                b = b + wj
                wb = b == nb
                b[wb] = 0
                i = i + wb
                new = wrap
            if new.any():
                nw = load(i, j)
                bi, bv, sign, gt = (np.where(new, x, y)
                                    for x, y in zip(nw, (bi, bv, sign, gt)))


def emulate(seeds, signs, leaves, *, mirror=False, alive=None,
            instance=None):
    """The wrapper and its launches: one int32 and one f32 buffer, every
    leaf's offset a multiple of 4, one launch per 64 leaves, segments with
    no slots left out, each launch in ``instance`` or, None, the one the
    launcher picks; ``alive`` sets the gate, global indices and the
    pair-major layout of the recovery streams. Returns ``(per-leaf (idx,
    vals), launches, the instances launched)``."""
    seeds = np.asarray(seeds).astype(np.int64).astype(U32)
    signs = np.asarray(signs, np.float32)
    rows, peers = seeds.shape
    al = None if alive is None else np.asarray(alive).astype(np.float32)
    pair_major = al is not None
    flags = (mirror * 1) | (pair_major * (2 | 4 | 8))
    n_slots = [rows * peers * nb * k for nb, k, _, _ in leaves]
    offsets, total = [], 0
    for n in n_slots:
        assert total % 4 == 0                       # 16-byte aligned
        offsets.append(total)
        total += -(-n // 4) * 4
    ibuf = np.full(total, -7, np.int32)
    vbuf = np.full(total, np.nan, np.float32)
    launched = []
    for lo in range(0, len(leaves), MAX_SEGMENTS):
        total = sum(n_slots[lo:lo + MAX_SEGMENTS])
        inst = instance or ("large" if total > ONE_WAVE else "small")
        TILE = THREADS * INSTANCES[inst][0]
        segs, tiles = [], 0
        for (nb, k, m, leaf), off, n in zip(leaves[lo:lo + MAX_SEGMENTS],
                                            offsets[lo:lo + MAX_SEGMENTS],
                                            n_slots[lo:lo + MAX_SEGMENTS]):
            if n == 0:
                continue
            segs.append(dict(
                off=off, n=n, nb=nb, k=k, m=m, tile0=tiles,
                fold=leaf is not None,
                leaf_key=_mix32(U32((int(leaf or 0) + int(LEAF_SALT))
                                    & 0xFFFFFFFF))))
            tiles += -(-n // TILE)
        if segs:
            _kernel(seeds, signs, al, flags, segs, ibuf, vbuf, inst)
            launched.append(inst)
    out = []
    for (nb, k, _, _), off, n in zip(leaves, offsets, n_slots):
        shape = (rows * peers, nb, k) if pair_major else (rows, nb, peers * k)
        i, v = ibuf[off:off + n], vbuf[off:off + n]
        assert (v == v).all(), "a slot was never written"
        out.append((i.reshape(shape), v.reshape(shape)))
    return out, len(launched), launched


# ------------------------------------------------------ the reference
@functools.partial(jax.jit, static_argnames=("nb", "k_mask", "m"))
def _j_masks(seeds, signs, leaf_id, *, nb, k_mask, m):
    return jse.mask_streams_all_pairs(seeds, signs, nb, k_mask, m, p=P, q=Q,
                                      leaf_id=leaf_id)


@functools.partial(jax.jit, static_argnames=("nb", "k_mask", "m"))
def _j_recovery(seeds, signs, alive, leaf_id, *, nb, k_mask, m):
    return jse.dropout_cancel_streams_seeded(seeds, signs, alive, nb, k_mask,
                                             m, p=P, q=Q, leaf_id=leaf_id)


def _matrices(C, seed, *, zero_signs=0):
    """A symmetric seed matrix (0 on the diagonal; the wrap-around seeds
    2^32-1 and 2^32-2 planted) and antisymmetric signs, with ``zero_signs``
    more pairs at sign 0."""
    rs = np.random.RandomState(seed)
    s = rs.randint(0, 2**32, (C, C), dtype=np.uint64).astype(np.int64)
    s = np.triu(s, 1)
    s[0, C - 1] = 2**32 - 1
    if C > 2:
        s[1, 2] = 2**32 - 2
    s = s + s.T
    g = np.triu(rs.choice([-1.0, 1.0], (C, C)), 1).astype(np.float32)
    g = g - g.T
    for _ in range(zero_signs):
        a, b = rs.choice(C, 2, replace=False)
        g[a, b] = g[b, a] = 0.0
    return s, g


def _survivors(C, seed):
    alive = np.ones(C, bool)
    alive[np.random.RandomState(seed).choice(C, max(1, C // 3),
                                             replace=False)] = False
    return alive


def _recovery_matrix(seeds, alive):
    """Seeds only at survivor->dropped entries (and their mirror), as
    ``RoundProtocol.recover_seeds`` fills them."""
    keep = (alive[:, None] & ~alive[None, :]) | (~alive[:, None]
                                                   & alive[None, :])
    return np.where(keep, seeds, 0)


def _k_masks(sizes, C, ratio=0.01):
    return [max(1, int(size * ratio / C)) for size in sizes]


def _leaves(sizes, C, *, nb=1, first_leaf=0):
    return [(nb, km, -(-size // nb), first_leaf + l)
            for l, (km, size) in enumerate(zip(_k_masks(sizes, C), sizes))]


# (C, leaf sizes, nb, seed, zero signs): mnist_mlp's four leaves (k_mask
# 313, 1, 4, 1), VGG16's 54 leaves at C = 3, nb > 1, every C from 2 to 9,
# zero signs off the diagonal, and 70 leaves (two launches; five sizes, so
# the reference compiles five programs)
CASES = ([(5, MNIST_SIZES, 1, 0, 0), (3, VGG16_SIZES, 1, 1, 0),
          (4, [3000, 101, 7], 3, 2, 1)]
         + [(C, [900, 37], 1, 10 + C, C // 3) for C in range(2, 10)]
         + [(3, [50 + 3 * (l % 5) for l in range(70)], 1, 30, 1)])
CASE_IDS = (["mnist_mlp", "vgg16_c3", "nb3"]
            + [f"C{C}" for C in range(2, 10)] + ["70_leaves"])


@pytest.mark.parametrize("instance", ["small", "large"])
@pytest.mark.parametrize("C,sizes,nb,seed,zeros", CASES, ids=CASE_IDS)
def test_emulated_round_launch_equals_reference(C, sizes, nb, seed, zeros,
                                                instance):
    """Every leaf's masks from the emulated round launch, in each instance
    of the kernel, equal the reference's per-leaf ``mask_streams_all_pairs``
    bit for bit (signed zeros of 0 signs included), one launch per 64
    leaves."""
    s, g = _matrices(C, seed, zero_signs=zeros)
    leaves = _leaves(sizes, C, nb=nb)
    got, launches, _ = emulate(s, g, leaves, mirror=True, instance=instance)
    assert launches == -(-len(leaves) // MAX_SEGMENTS)
    js, jg = jnp.asarray(s.astype(np.uint32)), jnp.asarray(g)
    for (nb_, km, m, leaf), (gi, gv) in zip(leaves, got):
        ji, jv = _j_masks(js, jg, leaf, nb=nb_, k_mask=km, m=m)
        _assert_bits(gi, ji)
        _assert_bits(gv, jv)
    assert any(np.signbit(v).any() and (v == 0).any() for _, v in got)


@pytest.mark.parametrize("instance", ["small", "large"])
@pytest.mark.parametrize("C,sizes,nb,seed,zeros", CASES, ids=CASE_IDS)
def test_emulated_recovery_launch_equals_reference(C, sizes, nb, seed,
                                                   zeros, instance):
    """Every leaf's recovery streams from the emulated launch (gate,
    global indices, pair-major layout) equal the reference's per-leaf
    ``dropout_cancel_streams_seeded``, from a matrix filled only at
    survivor->dropped entries; -0.0 where the gate is 0."""
    s, g = _matrices(C, seed, zero_signs=zeros)
    alive = _survivors(C, seed)
    rec = _recovery_matrix(s, alive)
    leaves = _leaves(sizes, C, nb=nb)
    got = emulate(rec, g, leaves, alive=alive, instance=instance)[0]
    js, jg = jnp.asarray(rec.astype(np.uint32)), jnp.asarray(g)
    ja = jnp.asarray(alive)
    for (nb_, km, m, leaf), (gi, gv) in zip(leaves, got):
        jb = _j_recovery(js, jg, ja, leaf, nb=nb_, k_mask=km, m=m)
        _assert_bits(gi, jb.indices)
        _assert_bits(gv, jb.values)


@pytest.mark.parametrize("n_pairs,nb,k_mask,m", [(15, 1, 313, 156800),
                                                 (7, 2, 5, 33),
                                                 (3, 1, 1100, 9)])
def test_emulated_flat_call_equals_pallas_kernel(n_pairs, nb, k_mask, m):
    """The flat per-pair call is one segment (rows = N, peers = 1, no
    mirror, no fold): equal to the Pallas kernel in interpret mode."""
    rs = np.random.RandomState(n_pairs)
    seeds = rs.randint(0, 2**32, n_pairs, dtype=np.uint64).astype(np.int64)
    seeds[0] = 2**32 - 1
    signs = rs.choice([-1.0, 0.0, 1.0], n_pairs).astype(np.float32)
    (gi, gv), = emulate(seeds[:, None], signs[:, None],
                        [(nb, k_mask, m, None)])[0]
    (li, lv), = emulate(seeds[:, None], signs[:, None],
                        [(nb, k_mask, m, None)], instance="large")[0]
    _assert_bits(li, gi)
    _assert_bits(lv, gv)
    ji, jv = jmask.pair_mask_streams(jnp.asarray(seeds.astype(np.uint32)),
                                     jnp.asarray(signs), nb=nb,
                                     k_mask=k_mask, m=m, interpret=True)
    _assert_bits(gi, ji)
    _assert_bits(gv, jv)
    ti, tv = ops.pair_mask_streams(torch.from_numpy(seeds),
                                   torch.from_numpy(signs), nb=nb,
                                   k_mask=k_mask, m=m)
    _assert_bits(ti, ji)
    _assert_bits(tv, jv)


def test_emulated_launch_above_the_shared_table():
    """33 clients: 1,089 pairs, past the 1,024 the shared table holds, so
    each thread computes its own pair's words; both kinds of launch."""
    C = 33
    s, g = _matrices(C, 5, zero_signs=3)
    alive = _survivors(C, 5)
    leaves = [(1, 2, 400, 0), (2, 1, 50, 3)]
    js, jg = jnp.asarray(s.astype(np.uint32)), jnp.asarray(g)
    got = emulate(s, g, leaves, mirror=True, instance="large")[0]
    for (nb, km, m, leaf), (gi, gv) in zip(leaves, got):
        ji, jv = _j_masks(js, jg, leaf, nb=nb, k_mask=km, m=m)
        _assert_bits(gi, ji)
        _assert_bits(gv, jv)
    rec = _recovery_matrix(s, alive)
    got = emulate(rec, g, leaves, alive=alive, instance="large")[0]
    for (nb, km, m, leaf), (gi, gv) in zip(leaves, got):
        jb = _j_recovery(jnp.asarray(rec.astype(np.uint32)), jg,
                         jnp.asarray(alive), leaf, nb=nb, k_mask=km, m=m)
        _assert_bits(gi, jb.indices)
        _assert_bits(gv, jb.values)


def test_launcher_picks_the_instance_by_size():
    """The main path's launches: a mnist_mlp round (7,975 slots) and the
    flat call at VGG16's 512x512x3x3 (70,770) take the small instance, a
    VGG16 round (736,575 slots) the large one."""
    s, g = _matrices(5, 8)
    pick = emulate(s, g, _leaves(MNIST_SIZES, 5), mirror=True)
    assert pick[2] == ["small"]
    assert sum(x.size for x, _ in pick[0]) == 7975
    flat = emulate(np.arange(15)[:, None], np.ones((15, 1)),
                   [(1, 4718, 2359296, None)])
    assert flat[2] == ["small"]
    slots = sum(25 * k for _, k, _, _ in _leaves(VGG16_SIZES, 5))
    assert slots == 736575 > ONE_WAVE > 70770


# ------------------------------------ the round functions on the CPU
@pytest.mark.parametrize("C,sizes,nb,seed,zeros",
                         [CASES[0], CASES[2], CASES[4], CASES[10]],
                         ids=["mnist_mlp", "nb3", "C3", "C9"])
def test_round_functions_equal_per_leaf_and_reference(C, sizes, nb, seed,
                                                      zeros):
    """``mask_streams_round`` / ``recovery_streams_round`` on the CPU (the
    per-leaf functions, looped) and the segmented plain version
    (``ops.pair_mask_segments``) equal the reference, leaf by leaf; the
    matrices go to the device in one copy (``round_matrices``)."""
    s, g = _matrices(C, seed, zero_signs=zeros)
    alive = _survivors(C, seed)
    rec = _recovery_matrix(s, alive)
    leaves = _leaves(sizes, C, nb=nb)
    ts, tg = tse.round_matrices(torch.device("cpu"), torch.from_numpy(s),
                                torch.from_numpy(g))
    assert ts.dtype == torch.int32 and tg.dtype == torch.float32
    tr, ta = tse.round_matrices(torch.device("cpu"), torch.from_numpy(rec),
                                torch.from_numpy(alive))
    assert ta.tolist() == alive.astype(np.float32).tolist()
    masks = tse.mask_streams_round(ts, tg, leaves, p=P, q=Q)
    segs = ops.pair_mask_segments(ts, tg, leaves, p=P, q=Q, mirror=True)
    recs = tse.recovery_streams_round(tr, tg, ta, leaves, p=P, q=Q)
    rsegs = ops.pair_mask_segments(tr, tg, leaves, p=P, q=Q, alive=ta)
    js, jg = jnp.asarray(s.astype(np.uint32)), jnp.asarray(g)
    jr, ja = jnp.asarray(rec.astype(np.uint32)), jnp.asarray(alive)
    for n, (nb_, km, m, leaf) in enumerate(leaves):
        ji, jv = _j_masks(js, jg, leaf, nb=nb_, k_mask=km, m=m)
        for i, v in (masks[n], segs[n], tse.mask_streams_all_pairs(
                ts, tg, nb_, km, m, p=P, q=Q, leaf_id=leaf)):
            _assert_bits(i, ji)
            _assert_bits(v, jv)
        jb = _j_recovery(jr, jg, ja, leaf, nb=nb_, k_mask=km, m=m)
        for i, v in (recs[n], rsegs[n]):
            _assert_bits(i, jb.indices)
            _assert_bits(v, jb.values)


def test_round_matrices_one_buffer_and_bits():
    """uint32 seeds come back as int32 lanes holding the same bits; signs
    and alive as f32; all three views of one buffer."""
    s = torch.tensor([[0, 2**32 - 1], [2**31, 5]], dtype=torch.int64)
    g = torch.tensor([[0.0, -1.0], [1.0, -0.0]])
    ts, tg, ta = tse.round_matrices(torch.device("cpu"), s, g,
                                    [True, False])
    assert ts.tolist() == [[0, -1], [-2**31, 5]]
    assert torch.equal(tg.view(torch.int32), g.view(torch.int32))
    assert ta.tolist() == [1.0, 0.0]
    assert ts.untyped_storage().data_ptr() == \
        tg.untyped_storage().data_ptr() == ta.untyped_storage().data_ptr()


def test_cpu_round_launches_nothing():
    ops.reset_launch_counts()
    s, g = _matrices(4, 3)
    ts, tg = tse.round_matrices(torch.device("cpu"), torch.from_numpy(s),
                                torch.from_numpy(g))
    tse.mask_streams_round(ts, tg, _leaves([100, 10], 4), p=P, q=Q)
    ops.pair_mask_segments(ts, tg, _leaves([100, 10], 4), mirror=True)
    assert ops.launch_counts()["pair_mask_streams"] == 0


def test_segmented_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import mask_prng

    s, g = _matrices(3, 1)
    with pytest.raises(ValueError):
        mask_prng.pair_mask_segments_cuda(torch.from_numpy(s),
                                          torch.from_numpy(g),
                                          [(1, 2, 10, 0)], mirror=True)


# ------------------------------------------- two rounds through run_round
@pytest.mark.parametrize("preset", ["secagg_quick", "tree_quick"])
def test_two_rounds_precomputed_masks_equal_per_leaf_path(preset,
                                                          monkeypatch):
    """Two rounds (a dropout round among them) through ``run_round`` with
    the round's precomputed masks and recovery streams, and with the
    per-leaf path (each leaf's encode and decode generating its own):
    parameters, residuals and the ledger bit-identical. A leaf handed
    another leaf's segment would differ."""
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get(preset).replace(rounds=2, eval_every=1, out_json=None)
    calls = {"masks": 0, "recovery": 0}
    real_masks, real_rec = tse.mask_streams_round, tse.recovery_streams_round

    def counted_masks(*a, **kw):
        calls["masks"] += 1
        return real_masks(*a, **kw)

    def counted_rec(*a, **kw):
        calls["recovery"] += 1
        return real_rec(*a, **kw)

    monkeypatch.setattr(tse, "mask_streams_round", counted_masks)
    monkeypatch.setattr(tse, "recovery_streams_round", counted_rec)
    a = Simulation(cfg, device="cpu")
    ra = a.run()
    assert calls["masks"] == 2 and calls["recovery"] >= 1
    assert min(e.n_survivors for e in ra.ledger.entries) \
        < cfg.clients_per_round
    monkeypatch.setattr(tse, "mask_streams_round",
                        lambda s, g, leaves, **kw: [None] * len(leaves))
    monkeypatch.setattr(tse, "recovery_streams_round",
                        lambda s, g, al, leaves, **kw: [None] * len(leaves))
    b = Simulation(cfg, device="cpu")
    rb = b.run()
    assert ra.ledger.summary() == rb.ledger.summary()
    for n in a.state.params:
        _assert_bits(a.state.params[n], b.state.params[n].numpy())
    for c in a.state.residuals:
        for n in a.state.residuals[c]:
            _assert_bits(a.state.residuals[c][n],
                         b.state.residuals[c][n].numpy())
