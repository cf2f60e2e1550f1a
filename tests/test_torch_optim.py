"""Port parity: the optimizers (``repro_torch.optim``: SGD, momentum with
and without Nesterov, AdamW with and without weight decay) against
``repro.optim`` over three steps on shared numpy parameters and gradients,
and the closed forms of the reference's own tests.

Tolerances: f32 leaves within 1e-6 relative plus 2.4e-7 absolute (one f32
ulp in [2, 4), where the largest parameters lie: under ``jit`` XLA
contracts products and sums such as ``beta * m + g`` and ``p - lr * u``
into FMAs, which round once where PyTorch rounds twice; measured <=
1.2e-7, one ulp in [1, 2)); a bf16 leaf of AdamW (moments in f32, the
update rounded once) within one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402

RTOL, ATOL = 1e-6, 2.4e-7
OPTS = {
    "sgd": dict(lr=0.1),
    "momentum": dict(lr=0.05, beta=0.9),
    "nesterov": dict(lr=0.05, beta=0.8, nesterov=True),
    "adamw": dict(lr=1e-2),
    "adamw_wd": dict(lr=1e-2, weight_decay=0.1, b2=0.99),
}


def _make(mod, name):
    kind = "momentum" if name == "nesterov" else name.split("_")[0]
    return getattr(mod, kind)(**OPTS[name])


def _draws(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"w": (4, 3), "b": (3,), "e": (2, 2, 5)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name", sorted(OPTS))
def test_three_steps_match_reference(name):
    params, grads = _draws()
    jopt, topt = _make(joptim, name), _make(toptim, name)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jopt.step)
    for g in grads:
        jp, js = jstep(jp, {n: jnp.asarray(v) for n, v in g.items()}, js)
        tp, ts = topt.step(tp, {n: torch.from_numpy(v) for n, v in g.items()},
                           ts)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=RTOL, atol=ATOL, err_msg=n)
    assert topt.name == jopt.name
    if name.startswith("adamw"):
        assert int(ts.count) == int(js.count) == 3
        for n in params:
            assert ts.mu[n].dtype == ts.nu[n].dtype == torch.float32


@pytest.mark.parametrize("name", ["sgd", "nesterov", "adamw_wd"])
def test_a_module_is_updated_in_place(name):
    params, grads = _draws(1)
    module = torch.nn.Module()
    for n, v in params.items():
        module.register_parameter(n, torch.nn.Parameter(
            torch.from_numpy(v.copy()), requires_grad=False))
    plain = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    opt = _make(toptim, name)
    ms, ps = opt.init(module), opt.init(plain)
    for g in grads:
        tg = {n: torch.from_numpy(v) for n, v in g.items()}
        out, ms = opt.step(module, tg, ms)
        plain, ps = opt.step(plain, tg, ps)
        assert out is module
    for n, p in module.named_parameters():
        assert torch.equal(p, plain[n]), n


def test_adamw_keeps_a_bf16_leaf_within_one_ulp():
    params, grads = _draws(2)
    jopt, topt = joptim.adamw(1e-2, weight_decay=0.05), toptim.adamw(
        1e-2, weight_decay=0.05)
    jp = {"w": jnp.asarray(params["w"]).astype(jnp.bfloat16)}
    tp = {"w": torch.from_numpy(params["w"]).to(torch.bfloat16)}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jax.jit(jopt.step)(
            jp, {"w": jnp.asarray(g["w"]).astype(jnp.bfloat16)}, js)
        tp, ts = topt.step(
            tp, {"w": torch.from_numpy(g["w"]).to(torch.bfloat16)}, ts)
    assert tp["w"].dtype == torch.bfloat16
    got = tp["w"].float().numpy()
    want = np.asarray(jp["w"].astype(jnp.float32))
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -8 + 1e-30)


def test_closed_forms():
    """The reference's own closed-form cases (``tests/test_optim.py``)."""
    opt = toptim.sgd(0.1)
    new, _ = opt.step({"w": torch.ones(3)}, {"w": torch.full((3,), 2.0)},
                      opt.init({"w": torch.ones(3)}))
    torch.testing.assert_close(new["w"], torch.full((3,), 0.8))

    opt = toptim.momentum(0.1, beta=0.5)
    p = {"w": torch.zeros(1)}
    s = opt.init(p)
    for _ in range(2):                  # m = 1 then 1.5; p = -0.1, -0.25
        p, s = opt.step(p, {"w": torch.ones(1)}, s)
    torch.testing.assert_close(p["w"], torch.tensor([-0.25]))

    opt = toptim.adamw(1e-2)
    g = torch.tensor([1.0, -1.0, 3.0, -0.5])
    p2, _ = opt.step({"w": torch.zeros(4)}, {"w": g},
                     opt.init({"w": torch.zeros(4)}))
    torch.testing.assert_close(p2["w"], -1e-2 * torch.sign(g), rtol=1e-4,
                               atol=0)

    opt = toptim.adamw(1e-1, weight_decay=0.1)
    p = {"w": torch.full((2,), 10.0)}
    p2, _ = opt.step(p, {"w": torch.zeros(2)}, opt.init(p))
    torch.testing.assert_close(p2["w"], torch.full((2,), 10.0 - 0.1 * 0.1
                                                   * 10.0))


def test_adamw_converges_on_a_quadratic():
    opt = toptim.adamw(0.1)
    p = {"w": torch.tensor([5.0, -3.0])}
    s = opt.init(p)
    for _ in range(200):
        p, s = opt.step(p, {"w": 2 * p["w"]}, s)
    assert float(p["w"].abs().max()) < 0.05
