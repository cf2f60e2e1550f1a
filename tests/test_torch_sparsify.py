"""Port parity: ``repro_torch.core.sparsify`` against ``repro.core.sparsify``
on shared numpy inputs — ``sparsify_leaf`` under every selector (f32 and
bf16; NaN, ±inf, ties, all-zero leaves, k above the sample size, leaves
below 1024 and not a multiple of the stride), ``densify`` with duplicates,
``first_occurrence_mask`` and ``member_of``, all bit-equal; then the
reference's own invariants (``tests/test_sparsify.py``) on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import sparsify as jsp  # noqa: E402
from repro.core.types import SparseStream as JStream  # noqa: E402
from repro.core.types import THGSConfig as JTHGS  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core.types import SparseStream as TStream  # noqa: E402
from repro_torch.core.types import THGSConfig as TTHGS  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _f32_bits(x) -> np.ndarray:
    """Bits of an array as f32 (bf16 widens exactly), every NaN one
    pattern: NaN payloads are not part of the contract."""
    if isinstance(x, torch.Tensor):
        a = x.detach().float().cpu().numpy()
    else:
        a = np.asarray(jnp.asarray(x, jnp.float32))
    a = np.where(np.isnan(a), np.float32(np.nan), a).astype(np.float32)
    return np.atleast_1d(a).view(np.int32)


def _leaf(seed: int, n: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(grad, residual) f32 of ``n`` elements, with ``kind``'s planted
    values."""
    rs = np.random.RandomState(seed)
    g = rs.standard_normal(n).astype(np.float32)
    r = (0.3 * rs.standard_normal(n)).astype(np.float32)
    if kind == "ties":            # a few magnitudes, many equal
        g = np.round(g * 2) / 2
        r = np.zeros_like(r)
    elif kind == "nan":           # a few NaN among the values
        g[rs.choice(n, max(1, n // 50), replace=False)] = np.nan
    elif kind == "nan_heavy":     # NaN outrank the sample's threshold rank
        g[rs.choice(n, n // 2, replace=False)] = np.nan
    elif kind == "inf":
        g[rs.choice(n, max(2, n // 40), replace=False)] = np.inf
        g[rs.choice(n, max(1, n // 60), replace=False)] = -np.inf
    elif kind == "zeros":
        g = np.zeros_like(g)
        r = np.zeros_like(r)
    return g, r


def _run_both(g, r, k, selector, sample_frac, dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = JTHGS(selector=selector, sample_frac=sample_frac)
    tcfg = TTHGS(selector=selector, sample_frac=sample_frac)
    want = jsp.sparsify_leaf(jnp.asarray(g, jdt), jnp.asarray(r, jdt), k,
                             jcfg)
    got = tsp.sparsify_leaf(torch.from_numpy(g).to(tdt),
                            torch.from_numpy(r).to(tdt), k, tcfg)
    return want, got


def _assert_same(want, got, dtype):
    _, tdt = DTYPES[dtype]
    assert got.stream.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.stream.indices.numpy(),
                                  np.asarray(want.stream.indices))
    assert got.stream.values.dtype == tdt and got.residual.dtype == tdt
    np.testing.assert_array_equal(_f32_bits(got.stream.values),
                                  _f32_bits(want.stream.values))
    assert got.residual.shape == tuple(want.residual.shape)
    np.testing.assert_array_equal(_f32_bits(got.residual),
                                  _f32_bits(want.residual))
    assert got.threshold.dtype == tdt
    np.testing.assert_array_equal(_f32_bits(got.threshold),
                                  _f32_bits(want.threshold))


# (n, k, sample_frac): below 1024 (stride 1), at 1024, strides 2 / 4 with n
# not a multiple of the stride, k above the sample size S, a large f
CASES = [(4, 2, 0.01), (37, 5, 0.01), (1024, 40, 0.01), (1500, 90, 0.01),
         (5001, 70, 0.01), (5000, 4000, 0.01), (3000, 300, 0.2),
         (12345, 123, 0.05)]


@pytest.mark.parametrize("selector", ["exact", "sampled", "local"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,f", CASES)
def test_sparsify_leaf_bit_equal(n, k, f, dtype, selector):
    g, r = _leaf(n + k, n, "normal")
    want, got = _run_both(g, r, k, selector, f, dtype)
    _assert_same(want, got, dtype)


@pytest.mark.parametrize("selector", ["exact", "sampled"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["ties", "nan", "nan_heavy", "inf",
                                  "zeros"])
@pytest.mark.parametrize("n,k", [(600, 25), (3001, 200), (3001, 2900)])
def test_sparsify_leaf_bit_equal_on_planted_values(n, k, kind, dtype,
                                                   selector):
    g, r = _leaf(7 * n + k, n, kind)
    want, got = _run_both(g, r, k, selector, 0.01, dtype)
    _assert_same(want, got, dtype)


def test_sampled_nan_threshold_keeps_the_first_k():
    """A sample whose threshold rank falls on NaN gates every element to 0,
    so the first k indices are kept, as the reference keeps them."""
    g, r = _leaf(3, 2000, "nan_heavy")
    want, got = _run_both(g, r, 50, "sampled", 0.01, "f32")
    _assert_same(want, got, "f32")
    np.testing.assert_array_equal(got.stream.indices.numpy(), np.arange(50))
    assert float(got.threshold) == 0.0


def test_sampled_gates_rows_with_fewer_than_k_above_the_threshold():
    """k above what passes the gate: the rest are gated zeros from the
    lowest index up, the threshold a gated 0."""
    g = np.zeros(3000, np.float32)
    g[::7] = np.random.RandomState(0).standard_normal(429).astype(np.float32)
    want, got = _run_both(g, np.zeros_like(g), 1000, "sampled", 0.01, "f32")
    _assert_same(want, got, "f32")
    assert float(got.threshold) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("size,n,seed", [(50, 200, 0), (1000, 300, 1),
                                         (7, 40, 2)])
def test_densify_with_duplicates_bit_equal(size, n, seed, dtype):
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, size, n).astype(np.int32)
    idx[::9] = idx[0]                       # a heavy duplicate
    idx[1] = -1                             # counts from the end, as JAX
    idx[2] = size + 3                       # dropped
    idx[3] = -size - 2                      # still negative: dropped
    vals = (rs.standard_normal(n) * 10.0 ** rs.randint(-3, 4, n)).astype(
        np.float32)
    vals[5] = -0.0
    jdt, tdt = DTYPES[dtype]
    want = jsp.densify(JStream(jnp.asarray(idx), jnp.asarray(vals)), size,
                       jdt)
    got = tsp.densify(TStream(torch.from_numpy(idx), torch.from_numpy(vals)),
                      size, tdt)
    assert got.dtype == tdt and got.shape == (size,)
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.parametrize("seed,n,dup", [(0, 2, 1), (1, 50, 3), (2, 200, 5),
                                        (3, 9, 2)])
def test_first_occurrence_mask_bit_equal(seed, n, dup):
    idx = np.random.RandomState(seed).randint(0, n, n * dup).astype(np.int32)
    want = np.asarray(jsp.first_occurrence_mask(jnp.asarray(idx)))
    got = tsp.first_occurrence_mask(torch.from_numpy(idx))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,q,t,hi", [(0, 4, 4, 10), (1, 100, 30, 60),
                                         (2, 50, 1, 5), (3, 20, 80, 1000)])
def test_member_of_bit_equal(seed, q, t, hi):
    rs = np.random.RandomState(seed)
    query = rs.randint(-2, hi + 3, q).astype(np.int32)
    table = rs.randint(0, hi, t).astype(np.int32)
    want = np.asarray(jsp.member_of(jnp.asarray(query), jnp.asarray(table)))
    got = tsp.member_of(torch.from_numpy(query), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


def test_member_of_reference_case():
    table = torch.tensor([5, 1, 9, 1], dtype=torch.int32)
    q = torch.tensor([1, 2, 9, 0], dtype=torch.int32)
    assert tsp.member_of(q, table).tolist() == [True, False, True, False]


# --------------------------------------- the reference's invariants, ported
CFG = TTHGS(s0=0.1, alpha=0.9, s_min=0.01)


@pytest.mark.parametrize("selector", ["exact", "sampled"])
@pytest.mark.parametrize("seed,n,k", [(0, 4, 1), (1, 77, 9), (2, 500, 50),
                                      (3, 3000, 40)])
def test_conservation(seed, n, k, selector):
    """sparse + residual == residual_in + grad (error feedback loses
    nothing)."""
    g, r = _leaf(seed, n, "normal")
    cfg = TTHGS(s0=0.1, alpha=0.9, s_min=0.01, selector=selector)
    out = tsp.sparsify_leaf(torch.from_numpy(g), torch.from_numpy(r), k, cfg)
    dense = tsp.densify(out.stream, n)
    np.testing.assert_allclose((dense + out.residual).numpy(), g + r,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,n,k", [(0, 4, 4), (1, 100, 7), (2, 500, 50)])
def test_topk_selects_largest(seed, n, k):
    g = np.random.RandomState(seed).standard_normal(n).astype(np.float32)
    out = tsp.sparsify_leaf(torch.from_numpy(g), torch.zeros(n), k, CFG)
    sent = np.sort(np.abs(out.stream.values.numpy()))
    kept = np.sort(np.abs(out.residual.numpy()))[::-1]
    assert sent[0] >= kept[0] - 1e-6


def test_residual_accumulates_over_rounds():
    g = torch.tensor([10.0, 0.1, 0.1, 0.1])
    r = torch.zeros(4)
    for _ in range(3):
        r = tsp.sparsify_leaf(g, r, 1, CFG).residual
    np.testing.assert_allclose(r[1:].numpy(), 0.3, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_selector_close_to_exact(seed):
    cfg = TTHGS(s0=0.1, alpha=0.9, s_min=0.01, selector="sampled",
                sample_frac=0.2)
    g = np.random.RandomState(seed).standard_normal(10_000).astype(
        np.float32)
    out = tsp.sparsify_leaf(torch.from_numpy(g), torch.zeros(10_000), 100,
                            cfg)
    exact = np.sort(np.abs(g))[-100:]
    got = np.sort(np.abs(out.stream.values.numpy()))
    assert np.intersect1d(exact, got).size >= 50
