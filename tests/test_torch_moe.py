"""Port parity: the MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on shared numpy inputs.

Each expert gets its own weights in both packages (the reference's
``init_moe`` broadcasts one matrix to all experts, which would hide a token
sent to the wrong expert). The router's choices (``eidx``) are compared
before the outputs. Tolerances: float32 2e-5 (the expert products and the
softmax summed in another order; measured ~1e-6), bfloat16 3e-2 (the
expert products round to bf16 in both packages, at other places). The
dispatch buffer is bit-equal and the combine's fold order is the
reference's: given the same expert outputs, the combined rows are
bit-equal in f32 and bf16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 3e-2
ARCHS = ["deepseek_moe_16b", "llama4_scout_17b_a16e"]
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _spec(arch):
    return tconfigs.reduced(tconfigs.get(arch)).moe


def _params(arch, dtype="float32", seed=0, router_scale=1.0):
    """The reference's init_moe tree with a different draw per expert, as
    numpy f32 (rounded through ``dtype``), and both packages' mappings."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    jd, td = DT[dtype]
    tree = jmoe.init_moe(jax.random.key(seed), jcfg.d_model, jcfg.moe,
                         jcfg.act, jd)
    rs = np.random.RandomState(seed + 100)
    flat = {}
    for name, leaf in tree.items():
        arr = np.asarray(leaf, np.float32)
        if name in ("wi_gate", "wi_up", "wo"):
            e, d_in, d_out = arr.shape
            arr = (rs.randn(e, d_in, d_out) * (2.0 / (d_in + d_out)) ** 0.5)
        if name == "router":
            arr = arr * router_scale
        flat[name] = np.asarray(arr, np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else jd)
          for k, v in flat.items()}
    tp = {k: torch.from_numpy(np.array(jp[k].astype(jnp.float32)))
          .to(torch.float32 if k == "router" else td) for k in flat}
    return jcfg.moe, jp, tp


def _x(shape, dtype="float32", seed=1, shift=0.0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) + shift
    jd, td = DT[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _ref_eidx(jp, jx, k):
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"], -1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def test_init_moe_draws_each_expert_and_keeps_the_reference_shapes():
    spec = _spec("deepseek_moe_16b")
    jcfg = jconfigs.reduced(jconfigs.get("deepseek_moe_16b"))
    p = tmoe.init_moe(torch.Generator().manual_seed(0), jcfg.d_model, spec,
                      jcfg.act, torch.float32, "cpu")
    ref = jmoe.init_moe(jax.random.key(0), jcfg.d_model, jcfg.moe, jcfg.act,
                        jnp.float32)
    assert sorted(p.keys()) == sorted(ref)
    for name in ref:
        assert tuple(p[name].shape) == ref[name].shape, name
    assert p["router"].dtype == torch.float32
    assert not torch.equal(p["wi_gate"][0], p["wi_gate"][1])
    d, f = jcfg.d_model, spec.d_ff_expert
    assert abs(p["wi_gate"].std().item() / (2 / (d + f)) ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("arch", ARCHS + ["full_deepseek"])
def test_capacity_is_the_reference_capacity(arch):
    spec = (tconfigs.get("deepseek_moe_16b").moe if arch == "full_deepseek"
            else _spec(arch))
    for n in (1, 2, 7, 12, 16, 64, 1000, 1024, 1025):
        assert tmoe.capacity(n, spec) == jmoe.capacity(n, spec), n
        assert tmoe.capacity(n, spec) % 8 == 0


def test_route_keeps_lax_top_k_tie_order():
    """Exact ties go to the lower expert id, as ``lax.top_k`` sends them."""
    probs = np.array([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                       [0.3, 0.1, 0.3, 0.3], [0.0, 0.5, 0.0, 0.5]]],
                     np.float32)
    for k in (1, 2, 3):
        vals, idx = tmoe.route(torch.from_numpy(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype):
    spec, jp, tp = _params(arch, dtype)
    jx, tx = _x((2, 12, 256), dtype)
    want = jax.jit(lambda p, x: jmoe.apply_moe(p, x, spec))(jp, jx)
    # the routing first: the same expert for every (token, rank)
    probs = torch.softmax(tx.float() @ tp["router"], -1)
    _, eidx = tmoe.route(probs, spec.top_k)
    np.testing.assert_array_equal(eidx.numpy(),
                                  _ref_eidx(jp, jx, spec.top_k))
    got = tmoe.apply_moe(tp, tx, spec)
    assert got.y.dtype == tx.dtype and tuple(got.y.shape) == (2, 12, 256)
    _close(want.y, got.y, F32_TOL if dtype == "float32" else BF16_TOL)
    _close(want.aux_loss, got.aux_loss, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_tokens_like_the_reference(arch):
    """A skewed router (inputs with a shared component, a large router)
    overflows an expert: the reference drops tokens (checked first, so the
    case cannot pass vacuously), and the port drops the same ones."""
    spec, jp, tp = _params(arch, router_scale=8.0)
    jx, tx = _x((2, 24, 256), shift=1.5)
    eidx = _ref_eidx(jp, jx, spec.top_k)
    cap = jmoe.capacity(24, spec)
    keep = [np.asarray(jmoe._dispatch_group(
        jx[g], jnp.asarray(eidx[g]), jnp.zeros(eidx[g].shape), spec.n_experts,
        spec.top_k, cap)[1][0]) for g in range(2)]
    assert sum(int((~kk).sum()) for kk in keep) > 0, "no token dropped"
    want = jmoe.apply_moe(jp, jx, spec)
    probs = torch.softmax(tx.float() @ tp["router"], -1)
    np.testing.assert_array_equal(tmoe.route(probs, spec.top_k)[1].numpy(),
                                  eidx)
    got = tmoe.apply_moe(tp, tx, spec)
    _close(want.y, got.y, F32_TOL)
    _close(want.aux_loss, got.aux_loss, F32_TOL)
    # the dropped assignments are those the reference drops
    _, slot, _ = tmoe._dispatch(tx, torch.from_numpy(eidx).long(),
                                spec.n_experts, spec.top_k, cap)
    dropped = (slot == spec.n_experts * cap).numpy()
    np.testing.assert_array_equal(dropped, ~np.stack(keep))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_are_bit_equal(dtype):
    """Given the same routing and expert outputs, the dispatch buffer and
    the combined rows are bit-equal: the combine folds a token's
    contributions in the reference's slot order (ascending expert id), in
    the model dtype, from +0.0."""
    spec, jp, tp = _params("deepseek_moe_16b", dtype, router_scale=8.0)
    jx, tx = _x((2, 24, 256), dtype, shift=1.5)
    e, k = spec.n_experts, spec.top_k
    cap = jmoe.capacity(24, spec)
    eidx = _ref_eidx(jp, jx, k)
    gates = np.random.RandomState(5).rand(2, 24, k).astype(np.float32)
    yexp = np.random.RandomState(6).randn(2, e, cap, 256).astype(np.float32)
    jd, td = DT[dtype]
    buf, slot, order = tmoe._dispatch(tx, torch.from_numpy(eidx).long(), e,
                                      k, cap)
    got = tmoe._combine(torch.from_numpy(yexp).to(td), slot, order,
                        torch.from_numpy(eidx).long(),
                        torch.from_numpy(gates), e, cap, td)
    for g in range(2):
        jbuf, disp = jmoe._dispatch_group(jx[g], jnp.asarray(eidx[g]),
                                          jnp.asarray(gates[g]), e, k, cap)
        np.testing.assert_array_equal(buf[g].float().numpy(),
                                      np.asarray(jbuf, np.float32))
        want = jmoe._combine_group(jnp.asarray(yexp[g]).astype(jd), disp,
                                   24, 256, e, cap, jd)
        assert np.array_equal(got[g].float().numpy().view(np.int32),
                              np.asarray(want, np.float32).view(np.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_token_groups_as_in_a_decode_step(arch):
    spec, jp, tp = _params(arch)
    jx, tx = _x((4, 1, 256), seed=3)
    want = jmoe.apply_moe(jp, jx, spec)
    got = tmoe.apply_moe(tp, tx, spec)
    _close(want.y, got.y, F32_TOL)
    _close(want.aux_loss, got.aux_loss, F32_TOL)


def test_no_shared_experts_and_top_k_one():
    spec, jp, tp = _params("llama4_scout_17b_a16e")
    spec = dataclasses.replace(spec, n_shared=0)
    jp = {k: v for k, v in jp.items() if not k.startswith("shared")}
    tp = {k: v for k, v in tp.items() if not k.startswith("shared")}
    jx, tx = _x((2, 10, 256), seed=4)
    want = jmoe.apply_moe(jp, jx, spec)
    got = tmoe.apply_moe(tp, tx, spec)
    _close(want.y, got.y, F32_TOL)
