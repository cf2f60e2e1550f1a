"""The bit-pack kernels' decomposition, emulated on the CPU.

``csrc/bitpack.cu`` packs and unpacks the stream wire in tiles that this
container cannot run. Its decomposition is emulated here in numpy, step for
step, and held bit-equal to the reference's Pallas kernels in interpret mode
(``repro.kernels.pack.bitpack_rows`` / ``bitunpack_rows``) and to the port's
plain versions, on shared numpy inputs:

* the segment table: up to 8 segments (``R, k, w, W`` each), segments
  without work left out, each with the first tile of its run; a CTA finds
  its segment by scanning the first tiles, then its row and its tile in
  the row;
* the tile: 32 chunks of 32 fields (1,024 fields, ``32*w`` words) of one
  row; pack stages the fields in shared memory padded by one word every 32
  fields, masked to ``w`` bits and zero past ``k``, then word ``j`` ORs in
  the fields from ``32j // w`` on (from 8 bits; below, a warp builds a
  chunk's ``w`` words as OR-reductions over its lanes, one field a lane);
  unpack does not stage: thread ``t`` extracts fields ``4t .. 4t+3`` from
  the tile's words (a second word only on a straddle);
* the ragged last tile of a row stores only the words below ``W`` / the
  fields below ``k``; every output is written exactly once;
* 32-bit offsets inside a tile (every bit offset below 2^15) and shifts in
  0..31 only, asserted as the kernel's note states them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import pack as jpack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TILE = 1024              # fields a CTA owns: 32 chunks of 32
THREADS = 256
GATHER_MIN_WIDTH = 8     # pack: a thread a word from 8 bits, a warp a chunk below
MAX_SEGMENTS = 8
KS = (1, 31, 32, 33, 1023, 1024, 1025, 7880)
# the Pallas kernels in interpret mode take about 0.25 s a call on the CPU:
# they see every k at the widths the codec path uses and the extremes, and
# the multi-tile ragged rows (k 1025, 7880) at every width; every case is
# held against the port's plain versions
PALLAS_ALL_K_WIDTHS = (1, 4, 8, 18, 22, 31, 32)
PALLAS_KS = (1025, 7880)
# the codec path's two-segment leaves: (R, k, index width, value width)
LEAF_PAIRS = {"mnist_mlp.l0.w.int8": (5, 7880, 18, 8),
              "cifar_vgg16.512x512x3x3.1bit": (5, 60199, 22, 1)}


def _fields(R, k, width, seed):
    """uint32 fields: low ``width`` bits random, with 0 and the maximum in
    row 0, and stray high bits above them (the port's kernels and plain
    versions take the low bits; the Pallas kernels get ``_low`` of them, as
    they take fields below ``2**width``)."""
    rs = np.random.RandomState(seed)
    u = rs.randint(0, 2**32, (R, k), dtype=np.uint64) >> np.uint64(
        32 - width)
    u[0, :2] = [0, 2**width - 1][:k]
    high = rs.randint(0, 2**32, (R, k), dtype=np.uint64)
    if width < 32:
        u |= (high >> np.uint64(width)) << np.uint64(width)
    return u.astype(np.uint32)


def _low(u, width):
    return u & np.uint32(0xFFFFFFFF if width == 32 else (1 << width) - 1)


# ------------------------------------------------------------ the emulation
def segment_table(segs):
    """``segs``: ``(R, k, w, W)`` each -> (table of the segments with work,
    tiles in the grid); each entry keeps its position in ``segs``."""
    assert 1 <= len(segs) <= MAX_SEGMENTS
    table, tiles = [], 0
    for i, (R, k, w, W) in enumerate(segs):
        assert 1 <= w <= 32
        if R == 0 or k == 0:
            continue
        per_row = -(-k // TILE)
        table.append(dict(i=i, R=R, k=k, w=w, W=W, per_row=per_row,
                          tile0=tiles))
        tiles += R * per_row
    assert tiles < 2**31
    return table, tiles


def place_of(table, b):
    """The kernel's ``place_of``: segment, row and tile within the row."""
    s = 0
    while s + 1 < len(table) and b >= table[s + 1]["tile0"]:
        s += 1
    sg = table[s]
    local = b - sg["tile0"]
    row = local // sg["per_row"]
    return sg, row, local - row * sg["per_row"]


def padded(s):
    return s + (s >> 5)


def _shl(x, n):
    n = np.asarray(n)
    assert ((n >= 0) & (n <= 31)).all(), "a shift outside 0..31"
    return np.left_shift(x, n.astype(np.uint32))


def _shr(x, n):
    n = np.asarray(n)
    assert ((n >= 0) & (n <= 31)).all(), "a shift outside 0..31"
    return np.right_shift(x, n.astype(np.uint32))


def pack_tile(src_row, out_row, tile, k, w, W, written):
    """One CTA of the pack kernel on one row's tile."""
    mask = np.uint32(0xFFFFFFFF if w == 32 else (1 << w) - 1)
    f0 = tile * TILE
    nf = min(TILE, k - f0)
    smem = np.zeros(TILE + TILE // 32, np.uint32)
    s = np.arange(TILE, dtype=np.int32)
    live = s < nf
    smem[padded(s[live])] = src_row[f0 + s[live]] & mask
    assert len(set(padded(s).tolist())) == TILE     # the pad keeps slots apart
    j0 = tile * 32 * w
    nw = min(32 * w, W - j0)
    assert nw == -(-nf * w // 32)                   # the ragged tile's words
    if w < GATHER_MIN_WIDTH:
        pack_chunks_by_warps(smem, out_row, nf, nw, j0, w, written)
        return
    j = np.arange(nw, dtype=np.int32)
    b = 32 * j
    assert (b < 2**15).all()                        # 32-bit in-tile offsets
    fs = b // w
    pos = fs * w - b
    assert ((pos > -w) & (pos <= 0)).all()
    word = _shr(smem[padded(fs)], -pos)
    pos = pos + w
    while (pos < 32).any():
        more = pos < 32
        fs = fs + more
        assert (fs < TILE).all()
        word = word | np.where(more, _shl(smem[padded(fs)],
                                          np.where(more, pos, 0)), 0)
        pos = pos + np.where(more, w, 0)
    out_row[j0:j0 + nw] = word
    written[j0:j0 + nw] += 1


def pack_chunks_by_warps(smem, out_row, nf, nw, j0, w, written):
    """The pack kernel below 8 bits: warp ``v`` takes chunks ``v, v + 8,
    ...`` of the tile; lane ``i`` places field ``i`` of the chunk at bit
    ``i*w`` (a low part, and a high part in the next word on a straddle) and
    each of the chunk's ``w`` words is the OR over the 32 lanes, kept by
    lane ``jj`` and stored if it lies below ``nw``."""
    lane = np.arange(32, dtype=np.int32)
    b = lane * w
    jl, off = b >> 5, b & 31
    nchunks = -(-nf // 32)
    for warp in range(THREADS // 32):
        for c in range(warp, nchunks, THREADS // 32):
            f = smem[padded(32 * c + lane)]
            lo = _shl(f, off)
            hi = np.where(off > 0, _shr(f, np.where(off > 0, 32 - off, 0)), 0)
            assert (hi[off + w <= 32] == 0).all()   # only a straddle carries
            assert (jl + (off + w > 32) < w).all()  # a chunk fills w words
            for jj in range(w):
                word = np.bitwise_or.reduce(
                    np.where(jl == jj, lo, 0) | np.where(jl + 1 == jj, hi, 0))
                if c * w + jj < nw:
                    out_row[j0 + c * w + jj] = word
                    written[j0 + c * w + jj] += 1


def unpack_tile(src_row, out_row, tile, k, w, W, written):
    """One CTA of the unpack kernel on one row's tile: thread ``t``
    extracts fields ``4t .. 4t+3``, each from the one or two words it needs
    among the tile's ``32*w`` (no staging)."""
    mask = np.uint32(0xFFFFFFFF if w == 32 else (1 << w) - 1)
    j0 = tile * 32 * w
    nw = min(32 * w, W - j0)
    words = src_row[j0:j0 + nw]
    f0 = tile * TILE
    nf = min(TILE, k - f0)
    s = (4 * np.arange(THREADS, dtype=np.int32)[:, None]
         + np.arange(4, dtype=np.int32)[None, :])   # thread t: 4t .. 4t+3
    live = s < nf
    b = s * w
    assert (b < 2**15).all()
    j = b >> 5
    off = b & 31
    assert (j[live] < nw).all()                     # reads stay in the tile
    x = _shr(words[np.minimum(j, nw - 1)], off)
    straddle = live & (off + w > 32)
    assert (off[straddle] > 0).all() and (j[straddle] + 1 < nw).all()
    hi = _shl(words[np.minimum(j + 1, nw - 1)], np.where(straddle,
                                                         32 - off, 0))
    v = (x | np.where(straddle, hi, 0)) & mask
    out_row[f0 + s[live]] = v[live]
    written[f0 + s[live]] += 1


def pack_segments_emulated(fields, widths):
    segs = [(u.shape[0], u.shape[1], w, tref.packed_words(u.shape[1], w))
            for u, w in zip(fields, widths)]
    outs = [np.zeros((R, W), np.uint32) for R, _, _, W in segs]
    written = [np.zeros((R, W), np.int32) for R, _, _, W in segs]
    table, tiles = segment_table(segs)
    for b in range(tiles):
        sg, row, tile = place_of(table, b)
        i = sg["i"]
        pack_tile(fields[i][row], outs[i][row], tile, sg["k"], sg["w"],
                  sg["W"], written[i][row])
    for wr in written:
        assert (wr == 1).all(), "a word not written exactly once"
    return outs


def unpack_segments_emulated(words, ks, widths):
    segs = [(x.shape[0], k, w, x.shape[1])
            for x, k, w in zip(words, ks, widths)]
    outs = [np.zeros((R, k), np.uint32) for R, k, _, _ in segs]
    written = [np.zeros((R, k), np.int32) for R, k, _, _ in segs]
    table, tiles = segment_table(segs)
    for b in range(tiles):
        sg, row, tile = place_of(table, b)
        i = sg["i"]
        unpack_tile(words[i][row], outs[i][row], tile, sg["k"], sg["w"],
                    sg["W"], written[i][row])
    for wr in written:
        assert (wr == 1).all(), "a field not written exactly once"
    return outs


def _pallas_case(width, k):
    return width in PALLAS_ALL_K_WIDTHS or k in PALLAS_KS


def _plain_pack(u, w):
    return tref.bitpack_rows_ref(torch.from_numpy(u.astype(np.int64)),
                                 w).numpy().astype(np.uint32)


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("width", range(1, 33), ids=lambda w: f"w{w}")
def test_tiles_bit_equal_to_pallas_and_plain(width):
    """Every k of KS at this width, R = 5 against the port's plain versions
    and the Pallas kernels in interpret mode (see PALLAS_KS); R = 1 (one of
    those rows alone) against the same rows. The R = 1 and R = 5 arrays of
    all k go through segmented emulations, 8 segments at a time."""
    arrays = []
    for k in KS:
        u5 = _fields(5, k, width, seed=width * 10_000 + k)
        arrays += [u5, u5[2:3].copy()]
    words = []
    for start in range(0, len(arrays), MAX_SEGMENTS):
        group = arrays[start:start + MAX_SEGMENTS]
        words += pack_segments_emulated(group, [width] * len(group))
    for idx, k in enumerate(KS):
        u5, u1 = arrays[2 * idx], arrays[2 * idx + 1]
        w5, w1 = words[2 * idx], words[2 * idx + 1]
        plain = _plain_pack(u5, width)
        np.testing.assert_array_equal(w5, plain, err_msg=f"pack k={k}")
        np.testing.assert_array_equal(w1, plain[2:3])
        if _pallas_case(width, k):
            np.testing.assert_array_equal(w5, np.asarray(jpack.bitpack_rows(
                jnp.asarray(_low(u5, width)), width, interpret=True)))
    back = []
    for start in range(0, len(words), MAX_SEGMENTS):
        group = words[start:start + MAX_SEGMENTS]
        back += unpack_segments_emulated(
            group, [a.shape[1] for a in arrays[start:start + MAX_SEGMENTS]],
            [width] * len(group))
    for idx, k in enumerate(KS):
        u5 = arrays[2 * idx]
        plain = tref.bitunpack_rows_ref(
            torch.from_numpy(words[2 * idx].astype(np.int64)), k, width)
        np.testing.assert_array_equal(back[2 * idx],
                                      plain.numpy().astype(np.uint32),
                                      err_msg=f"unpack k={k}")
        np.testing.assert_array_equal(back[2 * idx], _low(u5, width))
        np.testing.assert_array_equal(back[2 * idx + 1], _low(u5, width)[2:3])
        if _pallas_case(width, k):
            np.testing.assert_array_equal(back[2 * idx], np.asarray(
                jpack.bitunpack_rows(jnp.asarray(words[2 * idx]), k, width,
                                     interpret=True)))


@pytest.mark.parametrize("leaf", sorted(LEAF_PAIRS))
def test_leaf_pair_one_launch_bit_equal(leaf):
    """A leaf's index and value streams as one two-segment launch: the
    emulation, the Pallas kernels (interpret mode) per stream, and the
    port's segmented plain versions through ``ops`` agree, both ways."""
    R, k, wi, wv = LEAF_PAIRS[leaf]
    ui = _fields(R, k, wi, seed=wi)
    uv = _fields(R, k, wv, seed=wv)
    table, tiles = segment_table(
        [(R, k, w, tref.packed_words(k, w)) for w in (wi, wv)])
    assert [t["tile0"] for t in table] == [0, R * -(-k // TILE)]
    assert tiles == 2 * R * -(-k // TILE)
    ei, ev = pack_segments_emulated([ui, uv], [wi, wv])
    for got, u, w in ((ei, ui, wi), (ev, uv, wv)):
        np.testing.assert_array_equal(
            got, np.asarray(jpack.bitpack_rows(jnp.asarray(_low(u, w)), w,
                                               interpret=True)))
    oi, ov = ops.bitpack_segments(
        [torch.from_numpy(ui.view(np.int32)),
         torch.from_numpy(uv.view(np.int32))], widths=[wi, wv])
    assert oi.dtype == ov.dtype == torch.int32
    np.testing.assert_array_equal(oi.numpy().view(np.uint32), ei)
    np.testing.assert_array_equal(ov.numpy().view(np.uint32), ev)
    bi, bv = unpack_segments_emulated([ei, ev], [k, k], [wi, wv])
    np.testing.assert_array_equal(bi, _low(ui, wi))
    np.testing.assert_array_equal(bv, _low(uv, wv))
    np.testing.assert_array_equal(
        bi, np.asarray(jpack.bitunpack_rows(jnp.asarray(ei), k, wi,
                                            interpret=True)))
    ti, tv = ops.bitunpack_segments([oi, ov], ks=[k, k], widths=[wi, wv])
    np.testing.assert_array_equal(ti.numpy().view(np.uint32), bi)
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), bv)


def test_segment_table_skips_empty_segments_and_finds_every_tile():
    """Empty segments take no tile; every tile maps to one (segment, row,
    tile) and the map covers each segment's rows x tiles once."""
    segs = [(3, 0, 5, 0), (2, 2049, 7, tref.packed_words(2049, 7)),
            (0, 40, 3, tref.packed_words(40, 3)),
            (4, 1024, 32, 1024), (1, 1, 1, 1)]
    table, tiles = segment_table(segs)
    assert [t["i"] for t in table] == [1, 3, 4]
    assert [t["tile0"] for t in table] == [0, 6, 10]
    assert tiles == 11
    seen = [(place_of(table, b)[0]["i"], *place_of(table, b)[1:])
            for b in range(tiles)]
    assert seen == ([(1, r, t) for r in range(2) for t in range(3)]
                    + [(3, r, 0) for r in range(4)] + [(4, 0, 0)])


@pytest.mark.parametrize("widths", [(18, 8), (22, 1), (32, 31, 1, 7),
                                    tuple(range(25, 33))],
                         ids=["mnist-int8", "vgg-1bit", "mixed4", "eight"])
def test_ops_segments_on_cpu_equal_per_segment_rows(widths):
    """``ops.bitpack_segments`` / ``bitunpack_segments`` on CPU tensors (the
    plain versions) equal per-segment ``ops.bitpack_rows`` /
    ``bitunpack_rows``, on int32 lanes whose bit 31 is set (negative lanes)
    and with no launch counted."""
    ops.reset_launch_counts()
    rs = np.random.RandomState(sum(widths))
    fields, ks = [], []
    for i, w in enumerate(widths):
        k = int(rs.randint(1, 3000))
        u = _fields(1 + i % 3, k, w, seed=w + i)
        if w < 32:
            u[:, 0] |= np.uint32(1 << 31)              # a negative int32 lane
        fields.append(torch.from_numpy(u.view(np.int32)))
        ks.append(k)
    words = ops.bitpack_segments(fields, widths=list(widths))
    assert any((x < 0).any() for x in words)            # bit 31 set in words
    for u, w, x in zip(fields, widths, words):
        assert x.dtype == torch.int32
        want = ops.bitpack_rows(u.to(torch.int64) & tref.M32, width=w)
        assert torch.equal(x.to(torch.int64) & tref.M32, want)
    back = ops.bitunpack_segments(words, ks=ks, widths=list(widths))
    for u, w, k, x, y in zip(fields, widths, ks, words, back):
        assert y.dtype == torch.int32 and y.shape == (u.shape[0], k)
        want = ops.bitunpack_rows(x, k=k, width=w)
        assert torch.equal(y.to(torch.int64) & tref.M32, want)
        assert np.array_equal(y.numpy().view(np.uint32),
                              _low(u.numpy().view(np.uint32), w))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_segment_limits_refused():
    """More than 8 segments, a width outside 1..32, a missing k, and too few
    words are refused by the plain versions as by the launches."""
    u = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.bitpack_segments([u] * 9, widths=[3] * 9)
    with pytest.raises(ValueError):
        ops.bitpack_segments([u], widths=[3, 4])
    with pytest.raises(ValueError):
        ops.bitpack_segments([u], widths=[33])
    with pytest.raises(ValueError):
        ops.bitunpack_segments([u], ks=[], widths=[3])
    with pytest.raises(ValueError):
        ops.bitunpack_segments([u], ks=[5], widths=[32])
