"""The bf16 flash kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs its bf16 instances on the tensor cores, which
this container cannot reach. Its order of operations is emulated here in
PyTorch and held against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.flash_attention``, which takes T and S in multiples of
128) or the reference's plain version (other lengths), and against the port's
plain version, on shared numpy inputs:

* 128 x 128 tiles: a CTA's 128 query rows against key tiles of 128, the key
  columns past S zero-filled (as TMA fills them) and masked to -inf;
* bf16 inputs, f32 scores, kept in log2 units (``s * f32(hd^-0.5) *
  f32(log2 e)``) and exponentiated with exp2 (the kernel's ``ex2.approx.ftz``
  is within 2^-22 of it and flushes results below 2^-126 to 0); masked
  scores -1e30;
* the tile-skip rule of ``key_range`` (tiles wholly above the causal
  diagonal or before the window are not visited, unless some row of the
  block has no key);
* the online rescale of m, l and the accumulator in f32;
* P rounded to bf16 before P V (the one rounding the Pallas kernel lacks);
* one final rounding to bf16 of ``acc * (1 / max(l, 1e-30))`` (the kernel's
  reciprocal is the hardware's, within an ulp of this one).

What it shows, measured over the cases below: the skip rule is exact (a
skipped tile and a computed one give equal f32 bits); rows with no key get
the uniform average; with f32 inputs and P in f32 the emulation is within
7.2e-7 of the references (tolerance 2e-5), so the tiling, the log2 units and
exp2 cost nothing measurable; P's rounding to bf16 alone moves the output by
at most 3.8e-3 (1.4e-3 of max |out|) against the f32 references on the same
bf16 inputs, under its bound 2^-9 max |v| and 5x under 2e-2; and the bf16
output errs by at most 7.8e-3 (2^-7) against the bf16 references, 2.6x under
2e-2.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BQ = BK = 128
NEG_INF = -1e30
LOG2E = np.float32(1.4426950408889634)

# (B, T, S, H, Hkv, hd, causal, window), small: every rule of the kernel at
# least once — GQA and MQA, both head widths, no causal mask, a window that
# skips leading tiles, T > S with rows that have no key, T and S not
# multiples of 128, T != S
CASES = {
    "causal.hd64": (1, 256, 256, 4, 2, 64, True, None),
    "causal.hd128.mqa": (1, 256, 256, 4, 1, 128, True, None),
    "noncausal": (2, 256, 256, 2, 2, 64, False, None),
    "window100": (1, 384, 384, 4, 2, 64, True, 100),
    "window128.noncausal": (1, 384, 384, 2, 2, 128, False, 128),
    "t_gt_s.rows_without_keys": (1, 100, 40, 4, 2, 64, True, 8),
    "ragged": (2, 333, 333, 2, 1, 64, True, None),
    "ragged.t_ne_s": (1, 200, 333, 4, 2, 128, False, None),
}


def key_range(q0: int, q_last: int, S: int, causal: bool, window):
    """The kernel's tile-skip rule (``key_range`` in the source)."""
    lo, hi = 0, S - 1
    if window is None or q_last <= S + window - 2:
        if causal:
            hi = min(hi, q_last)
        if window is not None:
            lo = max(0, q0 - window + 1)
    return lo, hi


def emulate(q, k, v, *, causal, window, skip=True, p_bf16=True):
    """The kernel's order of operations -> f32 ``[B,T,H,hd]`` before the
    final rounding to bf16. ``skip=False`` visits every key tile;
    ``p_bf16=False`` keeps P in f32."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    s_pad = -(-S // BK) * BK
    qf = q.float().permute(0, 2, 1, 3)                       # B, H, T, hd
    kf, vf = (torch.nn.functional.pad(
        x.float().repeat_interleave(H // Hkv, dim=2).permute(0, 2, 1, 3),
        (0, 0, 0, s_pad - S)) for x in (k, v))               # TMA zero fill
    scale = torch.tensor(np.float32(hd ** -0.5) * LOG2E)
    out = torch.empty(B, H, T, hd)
    for q0 in range(0, T, BQ):
        q1 = min(q0 + BQ, T)
        lo, hi = (key_range(q0, q1 - 1, S, causal, window) if skip
                  else (0, S - 1))
        qpos = torch.arange(q0, q1)[:, None]
        m = torch.full((B, H, q1 - q0, 1), NEG_INF)
        l = torch.zeros(B, H, q1 - q0, 1)
        acc = torch.zeros(B, H, q1 - q0, hd)
        for k0 in range(lo // BK * BK, hi // BK * BK + 1, BK):
            kpos = torch.arange(k0, k0 + BK)[None, :]
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k0 + BK].transpose(-1, -2)
            ok = torch.ones(q1 - q0, BK, dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window is not None:
                ok &= kpos > qpos - window
            x = torch.where(ok, s * scale, NEG_INF)
            x = torch.where(kpos >= S, -torch.inf, x)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            m = m_new
            p = torch.exp2(x - m)
            l = l * alpha + p.sum(-1, keepdim=True)
            if p_bf16:
                p = p.bfloat16().float()
            acc = acc * alpha + p @ vf[:, :, k0:k0 + BK]
        out[:, :, q0:q1] = acc * (1 / l.clamp_min(1e-30))
    return out.permute(0, 2, 1, 3)


def _inputs(case: str, dtype):
    B, T, S, H, Hkv, hd, _, _ = CASES[case]
    rs = np.random.RandomState(sum(map(ord, case)))
    q, k, v = (rs.randn(*shape).astype(np.float32)
               for shape in ((B, T, H, hd), (B, S, Hkv, hd),
                             (B, S, Hkv, hd)))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(x).astype(jd) for x in (q, k, v)],
            [torch.from_numpy(x).to(dtype) for x in (q, k, v)])


@functools.lru_cache(maxsize=None)
def _references(case: str, dtype, f32_math: bool = False):
    """The reference's Pallas kernel in interpret mode where its wrapper
    takes the lengths, else its plain version; and the port's plain version;
    on inputs of ``dtype``, computed in f32 and rounded to ``dtype`` (or, with
    ``f32_math``, given those input values in f32 and not rounded). Both as
    f32 ``[B,T,H,hd]``, computed once a case."""
    _, T, S, _, _, _, causal, window = CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype)
    if f32_math:
        jq, jk, jv = (x.astype(jnp.float32) for x in (jq, jk, jv))
        q, k, v = q.float(), k.float(), v.float()
    if T % BQ == 0 and S % BK == 0:
        want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    else:
        want = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window)
    plain = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return (torch.from_numpy(np.array(want.astype(jnp.float32))),
            plain.float())


def _err(got, want) -> float:
    return (got - want).abs().max().item()


@pytest.mark.parametrize("case", CASES)
def test_bf16_output_within_tolerance_of_references(case):
    """bf16 inputs, P rounded to bf16, one final rounding: within 2e-2
    (atol and rtol, as the card holds the kernel) of the Pallas kernel or
    the reference's plain version, and of the port's plain version."""
    _, T, S, _, _, _, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.bfloat16)[1]
    out = emulate(q, k, v, causal=causal, window=window).bfloat16().float()
    for want in _references(case, torch.bfloat16):
        torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", CASES)
def test_bf16_p_error_is_bounded(case):
    """Before the final rounding, against the references in f32 on the same
    bf16 inputs, the only error left is P's rounding: each p is off by at
    most 2^-9 of itself, so the output by at most 2^-9 max |v|, far under
    2e-2."""
    _, T, S, _, _, _, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.bfloat16)[1]
    got = emulate(q, k, v, causal=causal, window=window)
    bound = 2.0 ** -9 * v.float().abs().max().item() + 1e-5
    for want in _references(case, torch.bfloat16, f32_math=True):
        assert _err(got, want) <= bound
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", CASES)
def test_f32_p_matches_references_tightly(case):
    """With f32 inputs and P kept in f32, the emulated order (tiles, skip
    rule, log2 units, exp2, online rescale) is within 2e-5 of the
    references: the tiling and exp2 cost nothing measurable."""
    _, T, S, _, _, _, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.float32)[1]
    got = emulate(q, k, v, causal=causal, window=window, p_bf16=False)
    for want in _references(case, torch.float32):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("p_bf16", [True, False], ids=["p_bf16", "p_f32"])
@pytest.mark.parametrize("case", CASES)
def test_skip_rule_is_exact(case, p_bf16):
    """Skipping the tiles wholly outside the causal band or the window gives
    the same f32 bits as visiting every tile: a skipped tile would add
    exp2(-1e30 - m) = 0 under a real max, or be scaled by 0 by the first
    real tile."""
    _, T, S, _, _, _, causal, window = CASES[case]
    q, k, v = _inputs(case, torch.bfloat16)[1]
    a = emulate(q, k, v, causal=causal, window=window, p_bf16=p_bf16)
    b = emulate(q, k, v, causal=causal, window=window, p_bf16=p_bf16,
                skip=False)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_skip_rule_skips_tiles():
    """The skip rule is not vacuous on these cases: causal blocks stop at
    their diagonal tile, windowed blocks start at the window's first tile,
    and a block with a keyless row visits every tile."""
    assert key_range(0, 127, 256, True, None) == (0, 127)
    assert key_range(256, 383, 384, True, 100) == (157, 383)
    assert key_range(0, 99, 40, True, 8) == (0, 39)          # rows 47+: none
    assert key_range(256, 383, 384, False, 128) == (129, 383)


def test_rows_without_a_key_get_the_uniform_average():
    """T > S with a window that ends before the keys start: rows 47..99 have
    no key, every score is -1e30, and the row averages all S keys — p is 1
    exactly in bf16 — as in the Pallas kernel and the plain versions."""
    _, T, S, H, Hkv, hd, causal, window = CASES["t_gt_s.rows_without_keys"]
    q, k, v = _inputs("t_gt_s.rows_without_keys", torch.bfloat16)[1]
    got = emulate(q, k, v, causal=causal, window=window)
    uniform = v.float().mean(1).repeat_interleave(H // Hkv, dim=1)
    keyless = got[:, S + window - 1:]
    assert keyless.shape[1] == T - (S + window - 1) == 53
    torch.testing.assert_close(keyless, uniform[:, None].expand_as(keyless),
                               rtol=1e-6, atol=1e-6)
    for want in _references("t_gt_s.rows_without_keys", torch.bfloat16):
        torch.testing.assert_close(keyless.bfloat16().float(),
                                   want[:, S + window - 1:], rtol=2e-2,
                                   atol=2e-2)
