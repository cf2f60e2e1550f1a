"""Port parity: the Mamba2 SSD block (``repro_torch.models.ssm``) against
``repro.models.ssm`` on shared numpy inputs, and the port's own chunked ==
recurrent contracts (as ``tests/test_recurrent_equivalence.py`` pins the
reference's).

Parameters are the reference's ``init_ssm`` draws, converted. Tolerances:
float32 2e-5 against the reference (the chunked sums and the port's
two-operand einsums run in another order than XLA's; measured ~1e-6),
bfloat16 3e-2; the chunked form against the recurrent steps 2e-3 / 2e-4
(rtol / atol), the reference's own tolerance for the same contract: the
chunked form sums decays as exp of cumulative sums, the recurrence as
products of per-step decays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SSMSpec as JSpec  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import SSMSpec  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 3e-2
# the reduced zamba2 spec: d_inner 128, 4 heads of 32, state 16, chunk 16
SPEC = dict(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16)
D = 64
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _params(dtype="float32", n_groups=1, seed=0):
    jspec = JSpec(n_groups=n_groups, **SPEC)
    tspec = SSMSpec(n_groups=n_groups, **SPEC)
    jd, td = DT[dtype]
    jp = jssm.init_ssm(jax.random.key(seed), D, jspec, jd)
    # non-trivial biases, so every parameter counts
    rs = np.random.RandomState(seed + 7)
    jp = dict(jp, conv_b=jnp.asarray(rs.randn(*jp["conv_b"].shape) * 0.1)
              .astype(jd),
              dt_bias=jnp.asarray(rs.randn(*jp["dt_bias"].shape) * 0.5,
                                  jnp.float32),
              D=jnp.asarray(1 + rs.randn(*jp["D"].shape) * 0.1, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else td)
        for k, v in jp.items()}
    return jspec, tspec, jp, tp


def _x(b, t, dtype="float32", seed=1):
    x = np.random.RandomState(seed).randn(b, t, D).astype(np.float32) * 0.5
    jd, td = DT[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def test_init_ssm_has_the_reference_leaves():
    jspec, tspec, jp, _ = _params()
    p = tssm.init_ssm(torch.Generator().manual_seed(0), D, tspec,
                      torch.float32, "cpu")
    assert sorted(p.keys()) == sorted(jp)
    for name, leaf in jp.items():
        assert tuple(p[name].shape) == leaf.shape, name
    ref = jssm.init_ssm(jax.random.key(0), D, jspec, jnp.float32)
    for name in ("conv_b", "A_log", "D", "dt_bias"):   # not drawn
        np.testing.assert_array_equal(p[name].numpy(), np.asarray(ref[name]))
    assert p["A_log"].dtype == torch.float32
    assert abs(p["conv_w"].std().item() / 0.1 - 1) < 0.1


def test_chunk_rule_is_the_reference_rule():
    """The chunk for a length the configured chunk does not divide is the
    largest divisor of T below it (it sets the rounding)."""
    q = 16
    for t in range(1, 50):
        want = q if t % q == 0 else next(
            d for d in range(min(q, t), 0, -1) if t % d == 0)
        assert tssm.chunk_len(t, q) == want, t
    assert tssm.chunk_len(1025, 128) == 41       # Zamba2's forward(T + 1)


@pytest.mark.parametrize("t", [48, 40, 37, 5])
def test_ssd_forward_matches_reference(t):
    """T = 48 (three chunks), 40 (chunks of 10), 37 (prime: chunks of 1),
    5 (shorter than the conv)."""
    jspec, tspec, jp, tp = _params()
    jx, tx = _x(2, t)
    jy, js = jax.jit(lambda p, x: jssm.ssd_forward(p, x, jspec))(jp, jx)
    ty, ts = tssm.ssd_forward(tp, tx, tspec)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == js.shape
    _close(jy, ty, F32_TOL)
    _close(js, ts, F32_TOL)


def test_ssd_forward_with_groups_and_init_state():
    jspec, tspec, jp, tp = _params(n_groups=2)
    jx, tx = _x(2, 32, seed=2)
    s0 = np.random.RandomState(3).randn(2, 4, 16, 32).astype(np.float32)
    jy, js = jssm.ssd_forward(jp, jx, jspec, init_state=jnp.asarray(s0))
    ty, ts = tssm.ssd_forward(tp, tx, tspec, init_state=torch.from_numpy(s0))
    _close(jy, ty, F32_TOL)
    _close(js, ts, F32_TOL)


def test_ssd_forward_bfloat16():
    jspec, tspec, jp, tp = _params("bfloat16")
    jx, tx = _x(2, 40, "bfloat16")
    jy, js = jssm.ssd_forward(jp, jx, jspec)
    ty, ts = tssm.ssd_forward(tp, tx, tspec)
    assert ty.dtype == torch.bfloat16
    _close(jy, ty, BF16_TOL)
    _close(js, ts, BF16_TOL)


def test_decode_steps_after_a_prefill_match_reference():
    """Three decode steps from the state a 21-token prefill leaves (its
    conv context the last 3 inputs), against the reference's steps."""
    jspec, tspec, jp, tp = _params()
    jx, tx = _x(2, 24, seed=4)
    _, js = jssm.ssd_forward(jp, jx[:, :21], jspec)
    _, ts = tssm.ssd_forward(tp, tx[:, :21], tspec)
    d_inner = 2 * D
    gn = 16
    conv = np.array((jx[:, 18:21] @ jp["in_proj"])[..., d_inner:
                                                      2 * d_inner + 2 * gn])
    jc = jssm.SSMCache(state=js, conv=jnp.asarray(conv))
    tcache = tssm.SSMCache(state=ts, conv=torch.from_numpy(conv))
    for i in range(21, 24):
        jy, jc = jssm.ssd_decode_step(jp, jx[:, i:i + 1], jc, jspec)
        ty, tcache = tssm.ssd_decode_step(tp, tx[:, i:i + 1], tcache, tspec)
        _close(jy, ty, F32_TOL)
        _close(jc.state, tcache.state, F32_TOL)
        _close(jc.conv, tcache.conv, F32_TOL)


@pytest.mark.parametrize("t", [64, 40])
def test_ssd_chunked_equals_recurrent(t):
    """The port's chunked prefill == its recurrent steps from an empty
    cache (outputs and final state), as the reference pins its own."""
    _, tspec, _, tp = _params()
    _, tx = _x(2, t, seed=5)
    y_par, s_final = tssm.ssd_forward(tp, tx, tspec)
    cache = tssm.init_cache(2, D, tspec, torch.float32, "cpu")
    ys = []
    for i in range(t):
        yt, cache = tssm.ssd_decode_step(tp, tx[:, i:i + 1], cache, tspec)
        ys.append(yt)
    torch.testing.assert_close(y_par, torch.cat(ys, 1), rtol=2e-3,
                               atol=2e-4)
    torch.testing.assert_close(s_final, cache.state, rtol=2e-3, atol=2e-4)


def test_ssd_state_continuation():
    """The first half of a run equals a run over the first half alone (the
    reference's check: later positions never reach earlier outputs)."""
    _, tspec, _, tp = _params()
    _, tx = _x(1, 32, seed=6)
    y_full, _ = tssm.ssd_forward(tp, tx, tspec)
    y1, _ = tssm.ssd_forward(tp, tx[:, :16], tspec)
    torch.testing.assert_close(y_full[:, :16], y1, rtol=1e-4, atol=1e-5)


def test_init_cache_matches_reference():
    jspec, tspec, _, _ = _params()
    jc = jssm.init_cache(3, D, jspec, jnp.bfloat16)
    tc = tssm.init_cache(3, D, tspec, torch.bfloat16, "cpu")
    assert tuple(tc.state.shape) == jc.state.shape
    assert tuple(tc.conv.shape) == jc.conv.shape
    assert tc.state.dtype == torch.float32 and tc.conv.dtype == torch.bfloat16
    assert not tc.state.any() and not tc.conv.any()


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [0.0, 1e-8, -1e-8, 88.0, -88.0]]).astype(np.float32)
    # atol: at x = -88 the result is subnormal (~6e-39), which one side
    # flushes to 0
    np.testing.assert_allclose(tssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2e-7, atol=1e-37)
