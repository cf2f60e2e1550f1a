"""Port parity: the flash-attention kernel's dispatch and plain version, the
layer primitives and the attention module against the JAX reference, on
shared numpy inputs.

The port's ``ops.flash_attention`` on a CPU tensor is its plain version
(``kernels/ref.py::flash_attention_ref``); it is held against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention``) on
that kernel's own test shapes, and against the reference's plain version at
lengths the Pallas wrapper does not take. The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_kernels.py``,
gpu-marked, and ``chip_smoke.py``).

Tolerances: f32 2e-5 and bf16 2e-2 for the kernel (the reference's own, in
``tests/test_kernels.py``); f32 layers 1e-5 relative (sum order and libm
ulps, measured <= 5e-7 relative); bf16 layers 2**-6 relative (two bf16
ulps: each package rounds its intermediates to bf16, and a product summed
in another order can round the other way, measured one ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str = "float32"):
    """The same f32 numpy array as a JAX and a torch array of ``dtype``
    (both round f32 to bf16 to nearest even, so the bits agree)."""
    jd, td = DT[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _qkv(b, t, s, h, hkv, hd, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, t, h, hd).astype(np.float32),
            rs.randn(b, s, hkv, hd).astype(np.float32),
            rs.randn(b, s, hkv, hd).astype(np.float32))


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("b,t,h,hkv,hd", [
    (1, 128, 4, 4, 64),     # group 1
    (2, 256, 4, 2, 64),     # group 2
    (1, 128, 8, 2, 64),     # group 4
    (1, 256, 8, 1, 128),    # MQA
])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_flash_attention_matches_pallas_kernel(b, t, h, hkv, hd, causal,
                                               window):
    q, k, v = _qkv(b, t, t, h, hkv, hd, seed=t + h + hkv)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes_match_pallas_kernel(dtype):
    q, k, v = _qkv(1, 128, 128, 4, 2, 64, seed=5)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jops.flash_attention(jq, jk, jv)
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == DT[dtype][1]
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(want, got, tol)


@pytest.mark.parametrize("t", [1, 24, 100, 200])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, 64)])
def test_flash_attention_any_length_matches_reference_oracle(t, causal,
                                                             window):
    """T = S need not be a multiple of 128 (the serving prompts are 24)."""
    q, k, v = _qkv(2, t, t, 8, 2, 64, seed=t)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_rows_without_keys_get_the_uniform_average():
    """Masked scores are -1e30, not -inf: a query row whose window ends
    before the keys start (T > S) averages every key, as the Pallas kernel
    does, instead of giving NaN."""
    q, k, v = _qkv(1, 100, 40, 4, 2, 64, seed=3)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=8)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    uniform = np.repeat(v.mean(axis=1, keepdims=True), 2, axis=2)
    np.testing.assert_allclose(got.numpy()[:, 60], uniform[:, 0], rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_cpu_tensor_launches_nothing_and_wrapper_refuses():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 1, 64, seed=1))
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------- layers
def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind, dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 12, 256) * 3).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(256)).astype(np.float32)
    bias = (0.1 * rs.randn(256)).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = (_both(a, dtype) for a in (x, scale, bias))
    got = tlayers.apply_norm({"scale": ts, "bias": tb}, tx, kind)
    assert got.dtype == tx.dtype
    _close(jlayers.apply_norm({"scale": js, "bias": jb}, jx, kind), got,
           _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["default", "2d", "none"])
def test_apply_rope_matches_reference(mode, dtype):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 40, 4, 64).astype(np.float32)
    pos = np.arange(7, 47)[None]
    jx, tx = _both(x, dtype)
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), mode)
    assert got.dtype == tx.dtype
    _close(jlayers.apply_rope(jx, jnp.asarray(pos), mode), got, _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp_matches_reference(act, dtype):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 12, 256).astype(np.float32)
    shapes = {"wi_gate": (256, 512), "wi_up": (256, 512), "wo": (512, 256)}
    if act == "gelu":
        shapes = {"wi": (256, 512), "wo": (512, 256)}
    w = {n: (rs.randn(*s) * 0.05).astype(np.float32)
         for n, s in shapes.items()}
    jp = {n: _both(a, dtype)[0] for n, a in w.items()}
    tp = {n: _both(a, dtype)[1] for n, a in w.items()}
    jx, tx = _both(x, dtype)
    _close(jlayers.apply_mlp(jp, jx, act), tlayers.apply_mlp(tp, tx, act),
           _tol(dtype))


def test_init_scales_follow_the_reference():
    g = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(g, 512, 1536, torch.float32, "cpu")
    e = tlayers.embed_init(g, 4096, 256, torch.float32, "cpu")
    assert tuple(w.shape) == (512, 1536) and not w.requires_grad
    assert abs(w.std().item() / (2.0 / 2048) ** 0.5 - 1) < 0.01
    assert abs(e.std().item() / 0.02 - 1) < 0.01
    p = tlayers.init_norm(8, "layernorm", torch.bfloat16, "cpu")
    assert torch.equal(p["scale"], torch.ones(8, dtype=torch.bfloat16))
    assert torch.equal(p["bias"], torch.zeros(8, dtype=torch.bfloat16))
    assert "bias" not in tlayers.init_norm(8, "rmsnorm", torch.float32, "cpu")


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 9])
def test_attend_with_causal_mask_matches_reference(window, dtype):
    q, k, v = _qkv(2, 30, 40, 4, 2, 64, seed=4)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    jm = jattn.causal_mask(30, 40, window)
    tm = tattn.causal_mask(30, 40, window)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    got = tattn.attend(tq, tk, tv, tm[None, None, None], 64)
    _close(jattn.attend(jq, jk, jv, jm[None, None, None], 64), got,
           _tol(dtype))


def _attn_params(d, h, hkv, hd, seed):
    rs = np.random.RandomState(seed)
    w = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
         "wo": (h * hd, d)}
    return {n: (rs.randn(*s) * (2.0 / sum(s)) ** 0.5).astype(np.float32)
            for n, s in w.items()}


@pytest.mark.parametrize("rope,window", [("default", None), ("2d", None),
                                         ("default", 5)])
def test_prefill_cache_matches_reference(rope, window):
    d, h, hkv, hd = 256, 4, 2, 64
    w = _attn_params(d, h, hkv, hd, seed=6)
    x = np.random.RandomState(7).randn(2, 13, d).astype(np.float32)
    kw = dict(n_heads=h, n_kv=hkv, hd=hd, rope=rope, window=window,
              cache_len=20)
    jo, jc = jattn.prefill_cache({n: jnp.asarray(a) for n, a in w.items()},
                                 jnp.asarray(x), **kw)
    to, tc = tattn.prefill_cache({n: torch.from_numpy(a)
                                  for n, a in w.items()},
                                 torch.from_numpy(x), **kw)
    _close(jo, to, F32_TOL)
    _close(jc.k, tc.k, F32_TOL)
    _close(jc.v, tc.v, F32_TOL)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert tc.length.dtype == torch.int32


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_self_attention_matches_reference(cache):
    """Three decode steps from a prefilled cache (float32/bfloat16) or from
    an empty int8 cache, window 6: outputs, caches and lengths. int8 rounds
    the new entries to the KV_QSCALE grid in both packages; a value on a .5
    boundary could round apart, which the f32 tolerance would catch."""
    d, h, hkv, hd = 256, 4, 2, 64
    dtype = "float32" if cache == "int8" else cache
    w = _attn_params(d, h, hkv, hd, seed=8)
    rs = np.random.RandomState(9)
    x = rs.randn(2, 10, d).astype(np.float32)
    jp = {n: _both(a, dtype)[0] for n, a in w.items()}
    tp = {n: _both(a, dtype)[1] for n, a in w.items()}
    kw = dict(n_heads=h, n_kv=hkv, hd=hd, rope="default", window=6)
    if cache == "int8":
        zeros = np.zeros((2, 16, hkv, hd), np.int8)
        jc = jattn.KVCache(k=jnp.asarray(zeros), v=jnp.asarray(zeros),
                           length=jnp.zeros((2,), jnp.int32))
        tc = tattn.KVCache(k=torch.from_numpy(zeros.copy()),
                           v=torch.from_numpy(zeros.copy()),
                           length=torch.zeros((2,), dtype=torch.int32))
    else:
        jx, tx = _both(x, dtype)
        _, jc = jattn.prefill_cache(jp, jx, cache_len=16, **kw)
        _, tc = tattn.prefill_cache(tp, tx, cache_len=16, **kw)
    for step in range(3):
        xs = rs.randn(2, 1, d).astype(np.float32)
        jx, tx = _both(xs, dtype)
        jo, jc = jattn.decode_self_attention(jp, jx, jc, **kw)
        to, tc2 = tattn.decode_self_attention(tp, tx, tc, **kw)
        assert tc2 is tc                   # written in place
        _close(jo, to, _tol(dtype))
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
    assert tc.k.dtype == (torch.int8 if cache == "int8" else DT[dtype][1])
    if cache == "int8":
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    else:
        _close(jc.k, tc.k, _tol(dtype))
        _close(jc.v, tc.v, _tol(dtype))


def test_decode_into_a_full_cache_writes_nothing():
    """A row at length == S gets no write (the reference's one-hot matches
    no slot) and still attends over the whole cache."""
    d, h, hkv, hd = 256, 4, 2, 64
    w = _attn_params(d, h, hkv, hd, seed=10)
    x = np.random.RandomState(11).randn(1, 4, d).astype(np.float32)
    kw = dict(n_heads=h, n_kv=hkv, hd=hd)
    jp = {n: jnp.asarray(a) for n, a in w.items()}
    tp = {n: torch.from_numpy(a) for n, a in w.items()}
    _, jc = jattn.prefill_cache(jp, jnp.asarray(x[:, :3]), cache_len=3, **kw)
    _, tc = tattn.prefill_cache(tp, torch.from_numpy(x[:, :3]), cache_len=3,
                                **kw)
    before = tc.k.clone()
    jo, jc = jattn.decode_self_attention(jp, jnp.asarray(x[:, 3:]), jc, **kw)
    to, tc = tattn.decode_self_attention(tp, torch.from_numpy(x[:, 3:]), tc,
                                         **kw)
    assert torch.equal(tc.k, before)
    _close(jo, to, F32_TOL)
    assert tc.length.tolist() == [4]
