"""A client's local SGD gives the same bits however many clients share the
vmapped call (DESIGN.md §11: sharded == serial bit-exactly, so the shard
count is purely a throughput knob).

Under ``vmap`` with per-client weights a convolution becomes one grouped
convolution over the clients, and the backend picks its algorithm by the
group count; on the card a batch-norm reduction also splits by the number
of outputs. ``paper_models.per_client`` runs those two ops one client at
a time under ``vmap``, so:

* (a) every paper model's per-client deltas and losses from
  ``batched_client_update`` (one set of params) and
  ``batched_client_update_multi`` (stale params stacked, the async update)
  at cohorts 2, 3, 4 and 1 (its row duplicated, as ``pad_one`` runs a
  one-client shard) are bit-equal to the same clients' at cohort 5;
* (b) ``paper_models.per_client`` of the models' convolution (and VGG16's
  convolution + BN) is the plain function and its autograd gradient bit
  for bit outside ``vmap``; under ``vmap``, with autograd over the
  vmapped forward (the conv models' local SGD), each client's output and
  gradients are the plain function's on its own tensors, bit for bit;
* (c) the port's VGG16 local SGD stays within rtol = atol = 1e-4 of the
  reference's ``batched_client_update`` at cohorts 2 and 5 (the models'
  VGG16 tolerance: 13 conv + BN layers amplify f32 round-off).

The deltas are compared at 4 intra-op threads, where the CPU's grouped
convolution rounds by the group count for mnist_cnn as well as VGG16.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import fedavg as jfa  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402

# model: (local steps, batch)
SHAPES = {"mnist_mlp": (2, 8), "mnist_cnn": (2, 8), "cifar_vgg16": (1, 4)}
LR = 0.05
THREADS = 4


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(old)


def _teq(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@functools.lru_cache(maxsize=None)
def _inputs(model):
    """Seeded inputs for 5 clients: the model's params, each client's stale
    params (client k's scaled by 1 + k/1000) and numpy batches."""
    steps, batch = SHAPES[model]
    m = pm.build_model(model).init_(torch.Generator().manual_seed(0))
    params = {n: p.detach().clone() for n, p in m.params().items()}
    scale = 1 + torch.arange(5, dtype=torch.float32) / 1000
    stale = {n: p * scale.view(-1, *[1] * p.dim())
             for n, p in params.items()}
    rs = np.random.RandomState(1)
    x = rs.randn(5, steps, batch, *m.input_shape).astype(np.float32)
    y = rs.randint(0, 10, (5, steps, batch))
    return m, params, stale, torch.from_numpy(x), torch.from_numpy(y)


@functools.lru_cache(maxsize=None)
def _run(model, C, multi):
    """(deltas, losses) of the first ``C`` clients in one call; C = 1 runs
    as two rows and keeps the first."""
    m, params, stale, x, y = _inputs(model)
    rows = 2 if C == 1 else C
    batches = tuple(torch.cat([t[:C]] * (rows // C)) for t in (x, y))
    loss = pm.cross_entropy_loss(m)
    steps = SHAPES[model][0]
    if multi:
        ps = {n: torch.cat([s[:C]] * (rows // C)) for n, s in stale.items()}
        d, losses = fedavg.batched_client_update_multi(ps, batches, loss,
                                                       steps, LR)
    else:
        d, losses = fedavg.batched_client_update(params, batches, loss,
                                                 steps, LR)
    return {n: v[:C] for n, v in d.items()}, losses[:C]


@pytest.mark.parametrize("multi", [False, True], ids=["sync", "multi"])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("model", list(SHAPES))
def test_client_bits_do_not_depend_on_cohort_size(model, C, multi):
    want, want_loss = _run(model, 5, multi)
    got, got_loss = _run(model, C, multi)
    apart = [n for n in want if not _teq(got[n], want[n][:C])]
    assert not apart, (
        f"{model}: {len(apart)} of {len(want)} leaves differ from the "
        f"cohort of 5, e.g. {apart[0]} by "
        f"{(got[apart[0]] - want[apart[0]][:C]).abs().max().item():.3e}")
    assert _teq(got_loss, want_loss[:C])


# ---------------------------------------------------------- (b) the ops
# name: (B, Cin, H, Cout, kernel, padding, with BN)
OP_SHAPES = {
    "vgg_c0": (4, 3, 32, 64, 3, 1, True),
    "vgg_c2": (4, 64, 16, 128, 3, 1, True),
    "cnn_c1": (4, 1, 28, 32, 5, 0, False),
    "cnn_c2": (4, 32, 12, 64, 5, 0, False),
}


def _op_inputs(shape, clients=None):
    """Seeded NHWC activations, an HWIO kernel, a bias (and BN's scale and
    bias), the cotangent: a leading client dim when ``clients``."""
    B, cin, H, cout, k, pad, bn = OP_SHAPES[shape]
    rs = np.random.RandomState(7)
    lead = () if clients is None else (clients,)
    ho = H + 2 * pad - k + 1
    arrays = [rs.randn(*lead, B, H, H, cin), 0.1 * rs.randn(*lead, k, k, cin,
                                                              cout),
              0.1 * rs.randn(*lead, cout)]
    if bn:
        arrays += [1 + 0.1 * rs.randn(*lead, cout), 0.1 * rs.randn(*lead,
                                                                    cout)]
    g = rs.randn(*lead, B, cout, ho, ho)
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays + [g]]


def _op(shape):
    """The model's op at ``shape`` (NCHW activations in): the plain
    function and the same through ``per_client``."""
    pad, bn = OP_SHAPES[shape][5:]
    plain = functools.partial(pm._conv_bn if bn else pm._conv2d,
                              padding=pad)
    return plain, lambda *a: pm.per_client(plain, *a)


def _value_and_grads(fn, args, g):
    """fn's output at ``args`` (the activations NHWC, permuted to NCHW as
    the models do) and autograd's gradient in every argument for the
    cotangent ``g``."""
    args = [t.clone().requires_grad_() for t in args]
    out = fn(args[0].movedim(-1, -3), *args[1:])
    return [out.detach()] + list(torch.autograd.grad(out, args, g))


@pytest.mark.parametrize("shape", list(OP_SHAPES))
def test_per_client_op_is_the_plain_op_and_its_gradient(shape):
    """Outside ``vmap``, ``per_client`` is the plain function, forward and
    gradient, bit for bit (its backward is the function's own vjp)."""
    *args, g = _op_inputs(shape)
    plain, wrapped = _op(shape)
    for x, y in zip(_value_and_grads(wrapped, args, g),
                    _value_and_grads(plain, args, g)):
        assert _teq(x, y)


@pytest.mark.parametrize("shape", list(OP_SHAPES))
def test_per_client_op_under_vmap_is_each_clients_own_call(shape):
    """The conv models' local SGD path: autograd over the vmapped op. Each
    client's output and gradients equal the plain function's on that
    client's own tensors, bit for bit, at 3 clients (what the plain
    function vmapped does not promise: a grouped convolution)."""
    *args, g = _op_inputs(shape, clients=3)
    _, wrapped = _op(shape)
    got = _value_and_grads(lambda *a: torch.func.vmap(wrapped)(*a), args,
                           g.unsqueeze(0).flatten(0, 1))
    plain, _ = _op(shape)
    for i in range(3):
        want = _value_and_grads(plain, [t[i] for t in args], g[i])
        for x, y in zip(got, want):
            assert _teq(x[i], y)


# ------------------------------------------------- (c) against the reference
def _named(tree):
    return {".".join(k.key for k in path): np.asarray(v, dtype=np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _vgg_runs():
    """VGG16's local SGD (5 clients, one step of 4) from the same params
    (the port's seeded init, as the reference's tree), in f32 and f64:
    the reference's at cohort 5 (its clients' bits do not depend on the
    cohort), the port's at cohorts 2 and 5."""
    jm = jpm.PAPER_MODELS["cifar_vgg16"]
    tm = pm.build_model("cifar_vgg16").init_(torch.Generator().manual_seed(4))
    jp = {}
    for n, p in tm.params().items():
        outer, inner = n.split(".")
        jp.setdefault(outer, {})[inner] = p.detach().numpy().copy()
    rs = np.random.RandomState(5)
    x = rs.randn(5, 1, 4, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, (5, 1, 4)).astype(np.int32)
    out = {}
    for dt in (np.float32, np.float64):
        with jax.enable_x64(dt == np.float64):
            jd, jl = jfa.batched_client_update(
                jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), jp),
                (jnp.asarray(x.astype(dt)), jnp.asarray(y)),
                jpm.cross_entropy_loss(jm), 1, LR)
            out["ref", dt] = _named(jd), np.asarray(jl, np.float64)
        tdt = torch.float32 if dt == np.float32 else torch.float64
        params = {n: p.detach().to(tdt) for n, p in tm.params().items()}
        for C in (2, 5):
            td, tl = fedavg.batched_client_update(
                params, (torch.from_numpy(x[:C]).to(tdt),
                         torch.from_numpy(y[:C].astype(np.int64))),
                pm.cross_entropy_loss(tm), 1, LR)
            out["port", dt, C] = ({n: v.double().numpy()
                                   for n, v in td.items()},
                                  tl.double().numpy())
    return out


@pytest.mark.parametrize("C", [2, 5])
def test_vgg16_local_sgd_within_1e4_of_the_reference(C):
    """In f64 the port's deltas and losses are the reference's to 1e-10:
    the same math. In f32 the losses
    agree within 1e-4, and so do the deltas of every client that neither
    package's f32 rounding moved across a relu or max-pool decision: at a
    batch of 4, one or two of the five clients' f32 deltas lie up to
    3e-3 from the f64 ones, in the reference as in the port, each package
    flipping its own near-ties; such a client is held by the f64
    comparison."""
    runs = _vgg_runs()
    (rd, rl), (td, tl) = runs["ref", np.float64], runs["port", np.float64, C]
    np.testing.assert_allclose(tl, rl[:C], rtol=0, atol=1e-10)
    for n in rd:
        np.testing.assert_allclose(td[n], rd[n][:C], rtol=0, atol=1e-10,
                                   err_msg=n)
    truth = rd
    (rd, rl), (td, tl) = runs["ref", np.float32], runs["port", np.float32, C]
    np.testing.assert_allclose(tl, rl[:C], rtol=1e-4, atol=1e-4)

    def off(d, c):
        return max(np.abs(d[n][c] - truth[n][c]).max() for n in truth)

    unflipped = [c for c in range(C) if max(off(rd, c), off(td, c)) <= 1e-4]
    assert unflipped
    for c in unflipped:
        for n in rd:
            np.testing.assert_allclose(td[n][c], rd[n][c], rtol=1e-4,
                                       atol=1e-4, err_msg=(n, c))


@pytest.mark.parametrize("prox_mu", [0.0, 0.1], ids=["fedavg", "fedprox"])
def test_conv_model_local_sgd_is_each_clients_own_client_update(prox_mu):
    """The conv models' path (autograd over the vmapped forward, FedProx's
    term included) against ``client_update`` run client by client: the
    same math, within rtol = atol = 1e-5 (f32 products in another
    order)."""
    m, params, _, x, y = _inputs("mnist_cnn")
    loss = pm.cross_entropy_loss(m)
    steps = SHAPES["mnist_cnn"][0]
    got, got_loss = fedavg.batched_client_update(params, (x, y), loss, steps,
                                                 LR, prox_mu)
    for c in range(5):
        want, want_loss = fedavg.client_update(params, (x[c], y[c]), loss,
                                               steps, LR, prox_mu)
        np.testing.assert_allclose(got_loss[c].item(), want_loss.item(),
                                   rtol=1e-5, atol=1e-5)
        for n in want:
            np.testing.assert_allclose(got[n][c].numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("prox_mu", [0.0, 0.1], ids=["fedavg", "fedprox"])
@pytest.mark.parametrize("model", ["mnist_mlp", "cifar_mlp"])
def test_mlp_local_sgd_is_the_grad_inside_vmap_program(model, prox_mu):
    """The MLPs run no per-client op, and autograd over the vmapped
    forward gives the bits that ``torch.func.grad_and_value`` inside
    ``vmap`` (the program before per-client ops) gives, stale params
    stacked, FedProx's term included."""
    m = pm.build_model(model).init_(torch.Generator().manual_seed(2))
    loss = pm.cross_entropy_loss(m)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(3, 2, 4, *m.input_shape).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, (3, 2, 4)))
    scale = 1 + torch.arange(3, dtype=torch.float32) / 1000
    ps = {n: p.detach() * scale.view(-1, *[1] * p.dim())
          for n, p in m.params().items()}
    got, got_loss = fedavg.batched_client_update_multi(ps, (x, y), loss, 2,
                                                       LR, prox_mu)
    want, want_loss = torch.func.vmap(
        lambda p, *b: fedavg._client_update(p, b, loss, 2, LR, prox_mu),
        randomness="error")(ps, x, y)
    for n in want:
        assert _teq(got[n], want[n]), n
    assert _teq(got_loss, want_loss)
