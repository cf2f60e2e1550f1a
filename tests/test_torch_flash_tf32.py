"""The f32 flash kernel's arithmetic (3xTF32 on the tensor cores), emulated
on the CPU.

``csrc/flash_attention.cu`` runs its f32 instances as ``wgmma`` in TF32,
which this container cannot reach. Its order of operations is emulated here
in PyTorch and held against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.flash_attention``, which takes T and S in multiples of
128) or the reference's plain version (other lengths), and against the port's
plain version, on shared numpy inputs (``test_torch_flash_tiles.CASES`` in
f32: every head width, GQA and MQA, a window, T > S with keyless rows,
ragged T and S):

* the TF32 rounding the kernel uses, ``cvt.rna.tf32.f32`` (round the f32
  bits at bit 13, ties away from zero), done with integer operations on the
  f32 bits;
* each operand split into ``hi = rna(x)`` and ``lo = rna(x - hi)`` (Q and K
  for the scores, P and V for the output), and each k8 step of a product
  accumulated in f32 as ``lo hi'``, then ``hi lo'``, then ``hi hi'`` (the
  eight-term sum of a step is exact products summed in f32, as the tensor
  core sums them);
* key tiles of 64, each row visiting the tiles its block of BQ rows visits
  (the skip rule of ``key_range``), in order, the key columns past S
  zero-filled (as ``cp.async`` fills them) and masked to -inf;
* the permutation of keys (and, in the kernel, of V^T's rows) inside each
  group of 8 that lets P feed the second product is a reordering of a sum
  of 8 exact products, which the emulation's eight-term sum leaves to its
  own order, as the tensor core does;
* the online softmax in f32: scores in log2 units (``s * f32(hd^-0.5) *
  f32(log2 e)``), exp2, masked scores -1e30, the rescale of m, l and the
  accumulator;
* ``acc * (1 / max(l, 1e-30))`` at the end.

What it shows, measured over the cases below: the three passes hold every
case within 1.7e-6 of the references (tolerance 2e-5), where one TF32 pass
misses by 2.4e-4 to 1.2e-3; the split's residual stays under 2^-22 |x|;
with |q| and |k| near 30 one pass misses by 4.3e-3 and three hold 7.8e-6
(V within 0.01 of 1); with V of unit spread, near ties between scores in
the thousands put three passes 7.6e-4 and a CUDA-core dot product 4.2e-4
from the exact result (one pass 0.44), the f32 accumulator's limit and not
the split's; and every row comes out bit for bit the same at the two
block heights the launch chooses from (64, 128), at 32, and with every tile
visited.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_flash_tiles import (CASES, _inputs,  # noqa: E402
                                    _references, key_range)

BK = 64
BLOCK_HEIGHTS = (64, 128)              # one or two warpgroups of 64 rows
NEG_INF = -1e30
LOG2E = np.float32(1.4426950408889634)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away from
    zero, as f32 whose low 13 bits are 0 (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return ((bits & -0x80000000) | mag).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: ``hi = rna(x)``, ``lo = rna(x - hi)``."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _product(acc, a, b, passes: int):
    """``acc + a @ b`` the kernel's way: k8 steps in order, each added to
    the f32 accumulator as three partial products, the small terms first
    (``passes=1``: one TF32 pass, ``hi hi'``; ``passes=0``: f32 products
    added one column at a time, as a CUDA-core dot product runs)."""
    if passes == 0:
        for c in range(a.shape[-1]):
            acc = acc + a[..., c:c + 1] * b[..., c:c + 1, :]
        return acc
    ah, al = split(a)
    bh, bl = split(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        terms = ((ah, bh),) if passes == 1 else ((al, bh), (ah, bl),
                                                 (ah, bh))
        for x, y in terms:
            acc = acc + x[..., ks] @ y[..., ks, :]
    return acc


def visited_tiles(T: int, S: int, causal: bool, window, bq):
    """The first and last key tile each query row visits: its block's
    ``key_range`` at block height ``bq`` (``None``: every tile)."""
    first = torch.empty(T, dtype=torch.long)
    last = torch.empty(T, dtype=torch.long)
    for q0 in range(0, T, bq or T):
        q1 = min(q0 + (bq or T), T)
        lo, hi = (key_range(q0, q1 - 1, S, causal, window) if bq
                  else (0, S - 1))
        first[q0:q1], last[q0:q1] = lo // BK, hi // BK
    return first, last


def emulate(q, k, v, *, causal, window, bq=64, passes=3):
    """The f32 instance's order of operations -> f32 ``[B,T,H,hd]``. Every
    row is carried through every key tile at once, and a row's state moves
    only on the tiles its block visits, in order."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_tiles = -(-S // BK)
    qf = q.float().permute(0, 2, 1, 3)                       # B, H, T, hd
    # cp.async zero-fills the keys past S
    kf, vf = (torch.nn.functional.pad(
        x.float().repeat_interleave(H // Hkv, dim=2).permute(0, 2, 1, 3),
        (0, 0, 0, n_tiles * BK - S)) for x in (k, v))
    scale = torch.tensor(np.float32(hd ** -0.5))
    log2e = torch.tensor(LOG2E)
    first, last = visited_tiles(T, S, causal, window, bq)
    qpos = torch.arange(T)[:, None]
    m = torch.full((B, H, T, 1), NEG_INF)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, hd)
    for j in range(n_tiles):
        visit = ((first <= j) & (j <= last))[:, None]
        if not visit.any():
            continue
        k0 = j * BK
        kpos = torch.arange(k0, k0 + BK)[None, :]
        kt, vt = kf[:, :, k0:k0 + BK], vf[:, :, k0:k0 + BK]
        s = _product(torch.zeros(B, H, T, BK), qf, kt.transpose(-1, -2),
                     passes)
        ok = torch.ones(T, BK, dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        x = torch.where(ok, s * scale, NEG_INF)
        x = torch.where(kpos >= S, -torch.inf, x)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((x - m_new) * log2e)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        acc_new = _product(acc * alpha, p, vt, passes)
        m = torch.where(visit, m_new, m)
        l = torch.where(visit, l_new, l)
        acc = torch.where(visit, acc_new, acc)
    return (acc * (1 / l.clamp_min(1e-30))).permute(0, 2, 1, 3)


def _err(got, want) -> float:
    return (got - want).abs().max().item()


# ----------------------------------------------------------- the split
def _rna_by_arithmetic(x: np.ndarray) -> np.ndarray:
    """An independent cvt.rna: the significand scaled to 11 bits, rounded
    half away from zero in f64, scaled back."""
    mant, exp = np.frexp(x.astype(np.float64))                # |mant| in [.5, 1)
    r = np.copysign(np.floor(np.abs(mant) * 2.0 ** 11 + 0.5), mant)
    return np.ldexp(r / 2.0 ** 11, exp).astype(np.float32)


def _wide_values(n: int, seed: int) -> np.ndarray:
    """Both signs, magnitudes over 2^-60..2^60, and exact ties at bit 13."""
    rs = np.random.RandomState(seed)
    x = (rs.choice([-1.0, 1.0], n) * 2.0 ** rs.uniform(-60, 60, n)
         ).astype(np.float32)
    ties = (x.view(np.int32) & ~0x1FFF) | 0x1000
    return np.concatenate([x, ties.view(np.float32),
                           np.float32([0.0, -0.0, 1.0, -1.5, 65504.0])])


def test_tf32_rounding_is_cvt_rna():
    """Integer rounding at bit 13 equals rounding the 11-bit significand half
    away from zero: ties go away from zero, the low 13 bits are 0, and the
    error is at most half a TF32 ulp (2^-11 |x|)."""
    x = _wide_values(20000, 0)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), _rna_by_arithmetic(x).view(
        np.int32))
    assert not (got.view(np.int32) & 0x1FFF).any()
    assert np.all(np.abs(got.astype(np.float64) - x)
                  <= 2.0 ** -11 * np.abs(x.astype(np.float64)))
    one = np.float32([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert tf32_rna(torch.from_numpy(one)).tolist() == [
        1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10]


def test_split_is_exact_to_2_pow_minus_22():
    """hi and lo exact in TF32, x - hi exact in f32, and the residual
    |x - hi - lo| at most 2^-22 |x|; lo carries what one TF32 pass drops."""
    x = _wide_values(20000, 1)
    hi, lo = (t.numpy() for t in split(torch.from_numpy(x)))
    for part in (hi, lo):
        assert not (part.view(np.int32) & 0x1FFF).any()
    x64, hi64, lo64 = (a.astype(np.float64) for a in (x, hi, lo))
    assert np.array_equal((x - hi).astype(np.float64), x64 - hi64)
    assert np.all(np.abs(x64 - hi64 - lo64) <= 2.0 ** -22 * np.abs(x64))
    one_pass = np.abs(x64 - hi64)
    assert one_pass.max() > 2.0 ** -13 * np.abs(x64[one_pass.argmax()])


# ------------------------------------------------- against the references
@pytest.mark.parametrize("case", CASES)
def test_three_passes_match_references(case):
    """f32 inputs, three TF32 passes, the online softmax in f32: within 2e-5
    (atol and rtol, as the card holds the kernel) of the Pallas kernel or
    the reference's plain version, and of the port's plain version."""
    _, T, S, _, _, _, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.float32)[1]
    got = emulate(q, k, v, causal=causal, window=window)
    for want in _references(case, torch.float32):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_one_pass_misses_where_three_hold(case):
    """One TF32 pass (hi hi' only) misses 2e-5 on every case, by more than
    ten times what three passes leave."""
    _, T, S, _, _, _, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.float32)[1]
    want = _references(case, torch.float32)[1]
    three = _err(emulate(q, k, v, causal=causal, window=window), want)
    one = _err(emulate(q, k, v, causal=causal, window=window, passes=1),
               want)
    assert three <= 2e-5 < one and one > 10 * three


def _large_operands(v_spread: float):
    """|q|, |k| in [27, 33] at hd 64, both signs: scores in the thousands,
    raw sums up to 1.6e4, a softmax sharp but for near ties; v = 1 +
    ``v_spread`` * N(0, 1)."""
    rs = np.random.RandomState(30)
    B, T, H, Hkv, hd = 1, 256, 4, 2, 64
    q = (30 * rs.uniform(0.9, 1.1, (B, T, H, hd))
         * rs.choice([-1, 1], (B, T, H, hd))).astype(np.float32)
    k = (30 * rs.uniform(0.9, 1.1, (B, T, Hkv, hd))
         * rs.choice([-1, 1], (B, T, Hkv, hd))).astype(np.float32)
    v = (1 + v_spread * rs.randn(B, T, Hkv, hd)).astype(np.float32)
    return q, k, v


def test_large_operands_need_three_passes():
    """With |q|, |k| near 30 one TF32 pass misses 2e-5 by two orders (scores
    off by about 2^-11 |q||k| sqrt(hd)) while three passes hold it, against
    the Pallas kernel and both plain versions. V's values lie within 0.01 of
    each other here: where two keys nearly tie, the output moves with the
    f32 error of the scores themselves times V's spread (the next test)."""
    q, k, v = _large_operands(0.01)
    want = [tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                     causal=True)]
    for fn in (jops.flash_attention, jref.flash_attention_ref):
        want.append(torch.from_numpy(np.array(
            fn(*map(jnp.asarray, (q, k, v)), causal=True, window=None))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    three = emulate(tq, tk, tv, causal=True, window=None)
    one = emulate(tq, tk, tv, causal=True, window=None, passes=1)
    for w in want:
        torch.testing.assert_close(three, w, rtol=2e-5, atol=2e-5)
        assert _err(one, w) > 100 * 2e-5


def test_large_scores_near_ties_are_f32_limited():
    """With V of unit spread, rows where two keys' scores (in the thousands)
    nearly tie move with the f32 rounding of the scores' sums (about 1e-3 at
    1.6e4): any f32 order that adds column after column misses 2e-5 there,
    the CUDA-core dot product of the previous f32 instance as much as three
    TF32 passes (within 3x of each other), one pass by a thousandfold. So at
    such magnitudes the split is not what limits the kernel; the f32
    accumulator is, and the tolerance holds at the magnitudes of
    ``FLASH_SHAPES`` and the models."""
    q, k, v = _large_operands(1.0)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    exact = tref.flash_attention_ref(tq.double(), tk.double(), tv.double(),
                                     causal=True).float()
    err = {p: _err(emulate(tq, tk, tv, causal=True, window=None, passes=p),
                   exact) for p in (0, 1, 3)}
    assert 2e-5 < err[0] and 2e-5 < err[3] <= 3 * err[0]
    assert err[1] > 1000 * 2e-5


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("case", CASES)
def test_rows_do_not_depend_on_block_height(case):
    """Every row comes out with the same f32 bits at the launch's block
    heights 64 and 128, at 32 and with every tile visited: the skip rule
    only adds or drops tiles that move a row by exact zeros (a masked tile
    after the row's real keys adds p = 0; one before them is scaled away by
    alpha = 0)."""
    _, T, S, _, _, _, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.float32)[1]
    outs = [emulate(q, k, v, causal=causal, window=window, bq=bq)
            for bq in (*BLOCK_HEIGHTS, 32, None)]
    for other in outs[1:]:
        assert torch.equal(outs[0], other)


def test_block_heights_skip_different_tiles():
    """The heights do visit different tiles on these cases, so the equality
    above is not vacuous: a windowed block of 128 rows starts earlier than
    its blocks of 64, and a causal block of 64 stops earlier."""
    f128, l128 = visited_tiles(384, 384, True, 100, 128)
    f64, l64 = visited_tiles(384, 384, True, 100, 64)
    assert (f64 > f128).any() and (l64 < l128).any()
    first, last = visited_tiles(100, 40, True, 8, 64)     # keyless rows
    assert (first == 0).all() and (last == 0).all()


def test_rows_without_a_key_get_the_uniform_average():
    """T > S with a window that ends before the keys start: rows 47..99 have
    no key, every score is -1e30, and the row averages all S keys (p is 1
    exactly, in both halves of the split: lo = 0), as in the Pallas kernel
    and the plain versions."""
    case = "t_gt_s.rows_without_keys"
    _, T, S, H, Hkv, hd, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.float32)[1]
    got = emulate(q, k, v, causal=causal, window=window)
    keyless = got[:, S + window - 1:]
    assert keyless.shape[1] == T - (S + window - 1) == 53
    uniform = v.float().mean(1).repeat_interleave(H // Hkv, dim=1)
    torch.testing.assert_close(keyless, uniform[:, None].expand_as(keyless),
                               rtol=2e-6, atol=2e-6)
    for want in _references(case, torch.float32):
        torch.testing.assert_close(keyless, want[:, S + window - 1:],
                                   rtol=2e-5, atol=2e-5)
