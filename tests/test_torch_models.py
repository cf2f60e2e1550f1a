"""Port parity: the paper's four models as ``nn.Module``s in the reference
layout — leaf names, order and shapes equal ``jax.tree_util.tree_flatten``'s,
the Table-1 counts are exact, and with the reference's parameters loaded
through ``convert.params_from_jax`` the forward passes agree to f32
tolerance: rtol=1e-5, atol=1e-5 (different summation orders in matmul and
convolution). VGG16 is held to rtol=1e-4, atol=1e-4: its 13 conv +
batch-norm layers amplify f32 round-off so that each package alone lies
~2e-5 from a float64 evaluation of the same network (checked below)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import paper_models as jpm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402

MODELS = ["mnist_mlp", "mnist_cnn", "cifar_mlp", "cifar_vgg16"]


def _jax_leaves(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return [(".".join(k.key for k in path), tuple(x.shape)) for path, x in flat]


@pytest.mark.parametrize("name", MODELS)
def test_layout_and_table1_counts(name):
    jp = jpm.PAPER_MODELS[name].init(jax.random.key(0))
    tm = tpm.build_model(name)
    got = [(n, tuple(p.shape)) for n, p in tm.params().items()]
    assert got == _jax_leaves(jp)
    assert tm.n_params() == tpm.TABLE1_PARAMS[name] == \
        jpm.TABLE1_PARAMS[name]
    assert tm.input_shape == tuple(jpm.PAPER_MODELS[name].input_shape)


@pytest.mark.parametrize("name", MODELS)
def test_forward_and_loss_match_reference(name):
    jm = jpm.PAPER_MODELS[name]
    jp = jm.init(jax.random.key(1))
    tm = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), name)
    rs = np.random.RandomState(2)
    x = rs.randn(3, *jm.input_shape).astype(np.float32)
    y = rs.randint(0, 10, 3).astype(np.int32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    tol = 1e-4 if name == "cifar_vgg16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if name == "cifar_vgg16":
        with torch.no_grad():
            truth = tm.apply({n: p.double() for n, p in tm.params().items()},
                             torch.from_numpy(x).double()).numpy()
        np.testing.assert_allclose(got, truth, rtol=tol, atol=tol)
        np.testing.assert_allclose(want, truth, rtol=tol, atol=tol)
    jl = float(jpm.cross_entropy_loss(jm)(jp, (jnp.asarray(x),
                                                jnp.asarray(y))))
    with torch.no_grad():
        tl = float(tpm.cross_entropy_loss(tm)(
            tm.params(), (torch.from_numpy(x), torch.from_numpy(y))))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


def test_accuracy_matches_reference():
    jm = jpm.PAPER_MODELS["mnist_mlp"]
    jp = jm.init(jax.random.key(3))
    tm = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 "mnist_mlp")
    rs = np.random.RandomState(4)
    x = rs.randn(700, 28, 28, 1).astype(np.float32)
    y = rs.randint(0, 10, 700).astype(np.int32)
    assert tpm.accuracy(tm, tm.params(), torch.from_numpy(x),
                        torch.from_numpy(y)) == \
        jpm.accuracy(jm, jp, jnp.asarray(x), jnp.asarray(y))
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_array_equal(tm.params()[name].detach().numpy(),
                                      np.asarray(v))


def test_params_from_jax_checks_names_and_shapes():
    jp = jax.tree_util.tree_map(
        np.asarray, jpm.PAPER_MODELS["mnist_mlp"].init(jax.random.key(0)))
    bad = {k: dict(v) for k, v in jp.items()}
    bad["l0"]["w"] = bad["l0"]["w"].T
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(bad, "mnist_mlp")
    del bad["l1"]
    with pytest.raises(ValueError, match="names"):
        convert.params_from_jax(bad, "mnist_mlp")


def test_port_init_is_seeded_and_scaled():
    a = tpm.build_model("mnist_cnn").init_(torch.Generator().manual_seed(5))
    b = tpm.build_model("mnist_cnn").init_(torch.Generator().manual_seed(5))
    for (n, p), q in zip(a.params().items(), b.params().values()):
        assert torch.equal(p, q), n
    w = a.params()["f1.w"].detach()
    assert abs(float(w.std()) - 0.5 * (2.0 / 1024) ** 0.5) < 2e-3
    assert float(a.params()["c1.b"].abs().sum()) == 0.0
