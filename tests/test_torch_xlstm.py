"""Port parity: the xLSTM cells (``repro_torch.models.xlstm``) against
``repro.models.xlstm`` on shared numpy inputs, and the port's own chunked ==
recurrent contracts (as ``tests/test_recurrent_equivalence.py`` pins the
reference's).

Parameters are the reference's ``init_slstm`` / ``init_mlstm`` draws,
converted. Tolerances: float32 2e-5 against the reference (sum order; the
sLSTM recurrence is contractive, measured ~1e-6 after 300 steps), bfloat16
3e-2; the mLSTM's chunked form against its stabilized recurrent steps 1e-3 /
1e-4 (rtol / atol), the reference's own tolerance for that contract (the
chunked form is unstabilized: exp of cumulative gate sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as jx  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 3e-2
D, H = 64, 4
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _params(kind, dtype="float32", seed=0):
    jd, td = DT[dtype]
    init = jx.init_slstm if kind == "s" else jx.init_mlstm
    jp = init(jax.random.key(seed), D, H, jd)
    if kind == "s":   # a non-zero bias, so it counts
        b = np.random.RandomState(seed + 3).randn(*jp["b"].shape) * 0.3
        jp = dict(jp, b=jnp.asarray(b).astype(jd))
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)
          for k, v in jp.items()}
    return jp, tp


def _x(b, t, dtype="float32", seed=1, scale=0.5):
    x = np.random.RandomState(seed).randn(b, t, D).astype(np.float32) * scale
    jd, td = DT[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _close_tree(js, ts, tol):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        _close(a, b, tol)


@pytest.mark.parametrize("kind", ["s", "m"])
def test_init_has_the_reference_leaves(kind):
    jp, _ = _params(kind)
    init = tx.init_slstm if kind == "s" else tx.init_mlstm
    p = init(torch.Generator().manual_seed(0), D, H, torch.float32, "cpu")
    assert sorted(p.keys()) == sorted(jp)
    for name, leaf in jp.items():
        assert tuple(p[name].shape) == leaf.shape, name
    if kind == "s":
        assert not p["b"].any()
        assert abs(p["r"].std().item() / 0.05 - 1) < 0.05


@pytest.mark.parametrize("t", [1, 20, 300])
def test_slstm_forward_matches_reference(t):
    """T = 300 (above CHUNK_T but not a multiple: the reference's plain
    scan), 20, and T = 1, a decode-sized call."""
    jp, tp = _params("s")
    jxx, txx = _x(2, t)
    jy, jc = jax.jit(lambda p, x: jx.slstm_forward(p, x, H))(jp, jxx)
    ty, tc = tx.slstm_forward(tp, txx, H)
    _close(jy, ty, F32_TOL)
    _close_tree(jc, tc, F32_TOL)


def test_slstm_two_level_scan_and_cache_continuation():
    """T = 256 runs the reference's remat chunks; the port's loop gives the
    same values, and continuing from the state after 200 steps gives the
    last 56."""
    jp, tp = _params("s", seed=2)
    jxx, txx = _x(2, 256, seed=2)
    jy, jc = jx.slstm_forward(jp, jxx, H)
    ty, tc = tx.slstm_forward(tp, txx, H)
    _close(jy, ty, F32_TOL)
    _close_tree(jc, tc, F32_TOL)
    _, mid = tx.slstm_forward(tp, txx[:, :200], H)
    ty2, tc2 = tx.slstm_forward(tp, txx[:, 200:], H, cache=mid)
    torch.testing.assert_close(ty2, ty[:, 200:], rtol=1e-5, atol=1e-6)


def test_slstm_bfloat16():
    jp, tp = _params("s", "bfloat16")
    jxx, txx = _x(2, 24, "bfloat16")
    jy, jc = jx.slstm_forward(jp, jxx, H)
    ty, tc = tx.slstm_forward(tp, txx, H)
    assert ty.dtype == torch.bfloat16
    _close(jy, ty, BF16_TOL)
    _close_tree(jc, tc, BF16_TOL)


@pytest.mark.parametrize("t", [20, 512, 300])
def test_mlstm_forward_matches_reference(t):
    """T = 20 (one chunk), 512 (two chunks of CHUNK_M = 256), 300 (not a
    multiple: one chunk of 300)."""
    jp, tp = _params("m")
    jxx, txx = _x(2, t, seed=3)
    jy, jc = jax.jit(lambda p, x: jx.mlstm_forward(p, x, H))(jp, jxx)
    ty, tc = tx.mlstm_forward(tp, txx, H)
    _close(jy, ty, F32_TOL)
    _close_tree(jc, tc, F32_TOL)
    assert not tc[2].any()                     # m returned as zeros


def test_mlstm_forward_from_a_cache_matches_reference():
    jp, tp = _params("m", seed=4)
    jxx, txx = _x(2, 16, seed=4)
    rs = np.random.RandomState(5)
    dh = 2 * D // H
    cache = (rs.randn(2, H, dh, dh).astype(np.float32) * 0.1,
             rs.randn(2, H, dh).astype(np.float32) * 0.1,
             rs.randn(2, H).astype(np.float32) * 0.5)
    jy, jc = jx.mlstm_forward(jp, jxx, H, cache=tuple(map(jnp.asarray,
                                                         cache)))
    ty, tc = tx.mlstm_forward(tp, txx, H, cache=tuple(
        map(torch.from_numpy, cache)))
    _close(jy, ty, F32_TOL)
    _close_tree(jc, tc, F32_TOL)


def test_mlstm_decode_steps_after_a_prefill_match_reference():
    jp, tp = _params("m", seed=6)
    jxx, txx = _x(2, 23, seed=6)
    _, jc = jx.mlstm_forward(jp, jxx[:, :20], H)
    _, tc = tx.mlstm_forward(tp, txx[:, :20], H)
    for i in range(20, 23):
        jy, jc = jx.mlstm_decode_step(jp, jxx[:, i:i + 1], jc, H)
        ty, tc = tx.mlstm_decode_step(tp, txx[:, i:i + 1], tc, H)
        _close(jy, ty, F32_TOL)
        _close_tree(jc, tc, F32_TOL)


def test_mlstm_bfloat16():
    jp, tp = _params("m", "bfloat16", seed=7)
    jxx, txx = _x(2, 24, "bfloat16", seed=7)
    jy, jc = jx.mlstm_forward(jp, jxx, H)
    ty, tc = tx.mlstm_forward(tp, txx, H)
    assert ty.dtype == torch.bfloat16
    _close(jy, ty, BF16_TOL)
    _close_tree(jc, tc, BF16_TOL)


@pytest.mark.parametrize("t", [512, 40])
def test_mlstm_chunked_equals_recurrent(t):
    """The port's chunked prefill (two chunks at T = 512, one at 40) == its
    stabilized recurrent steps from a zero state, outputs and the final
    state (the recurrent state unfolded by exp(m))."""
    _, tp = _params("m", seed=8)
    _, txx = _x(2, t, seed=8)
    y_par, (c, n, m) = tx.mlstm_forward(tp, txx, H)
    dh = 2 * D // H
    cache = (torch.zeros(2, H, dh, dh), torch.zeros(2, H, dh),
             torch.zeros(2, H))
    ys = []
    for i in range(t):
        yt, cache = tx.mlstm_decode_step(tp, txx[:, i:i + 1], cache, H)
        ys.append(yt)
    torch.testing.assert_close(y_par, torch.cat(ys, 1), rtol=1e-3,
                               atol=1e-4)
    torch.testing.assert_close(
        c, cache[0] * torch.exp(cache[2])[..., None, None], rtol=1e-3,
        atol=1e-4)


def test_slstm_prefill_equals_its_decode_steps():
    """sLSTM has one form: a prefill over T equals T one-token calls
    carrying the state (the decode path), to the rounding of the input
    projection (a product over T rows against one row, measured ~7e-7)."""
    _, tp = _params("s", seed=9)
    _, txx = _x(2, 12, seed=9)
    y_par, c_par = tx.slstm_forward(tp, txx, H)
    dh = 2 * D // H
    z = torch.zeros(2, H, dh)
    carry = (z, torch.ones_like(z), z, z)
    ys = []
    for i in range(12):
        yt, carry = tx.slstm_forward(tp, txx[:, i:i + 1], H, cache=carry)
        ys.append(yt)
    torch.testing.assert_close(y_par, torch.cat(ys, 1), rtol=F32_TOL,
                               atol=F32_TOL)
    for a, b in zip(c_par, carry):
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)
