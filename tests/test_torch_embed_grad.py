"""Port: the embedding gather's gradient is repeatable
(``models/layers.py::embed_lookup``): the rows of repeated tokens fold in
token order on every device and thread count, with no global flag.

* ``fold_rows`` equals adding the rows one at a time in token order in
  f32 and rounding once (f32 and bf16 rows), bit for bit;
* on 8 CPU threads, two ``value_and_grad`` runs of reduced Yi-6B over a
  512-token row of heavily repeated tokens give bit-equal ``embed``
  gradients with ``torch.use_deterministic_algorithms`` off;
* that gradient stays within the f32 training tolerance of
  ``jax.value_and_grad`` (every leaf within 1e-4 of its max |g|, as in
  ``tests/test_torch_train.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.layers import embed_lookup, fold_rows  # noqa: E402

GRAD_REL = 1e-4
T = 512


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_rows_adds_in_token_order(dtype):
    rs = np.random.RandomState(0)
    idx = torch.from_numpy(rs.randint(0, 7, 300))
    rows = torch.from_numpy(rs.randn(300, 5).astype(np.float32) * 1e3).to(
        dtype)
    want = torch.zeros((9, 5), dtype=torch.float32)
    for i, r in zip(idx.tolist(), rows):
        want[i] = want[i] + r.float()  # one add at a time, in token order
    assert (_bits(fold_rows(idx, rows, 9)) == _bits(want.to(dtype))).all()
    assert not fold_rows(idx[:0], rows[:0], 9).any()


def test_embed_lookup_gradient_is_the_fold():
    table = torch.randn((11, 4), requires_grad=True)
    tokens = torch.tensor([[3, 3, 1], [3, 0, 1]], dtype=torch.int32)
    out = embed_lookup(table, tokens)
    assert torch.equal(out, table.detach()[tokens.long()])
    g = torch.randn(out.shape)
    got, = torch.autograd.grad(out, table, g)
    assert torch.equal(got, fold_rows(tokens.reshape(-1).long(),
                                      g.reshape(-1, 4), 11))


def _pair():
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("yi_6b")),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get("yi_6b")),
                               dtype="float32")
    params = jtf.init_params(jcfg, jax.random.key(0))
    model = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def test_embed_gradient_repeats_on_eight_threads_without_a_flag():
    jcfg, tcfg, params, model = _pair()
    rs = np.random.RandomState(7)
    # 512 tokens from 24 ids: each id ~21 times
    batch = {"tokens": rs.randint(0, 24, (1, T)).astype(np.int32),
             "labels": rs.randint(0, tcfg.vocab, (1, T)).astype(np.int32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        assert not torch.are_deterministic_algorithms_enabled()
        runs = [ttrain.value_and_grad(model, tcfg, tbatch) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    (l1, g1), (l2, g2) = runs
    assert (_bits(g1["embed"]) == _bits(g2["embed"])).all()
    assert (_bits(l1) == _bits(l2)).all()
    _, jg = jax.value_and_grad(lambda p: jtf.train_loss(p, jcfg, {
        k: jax.numpy.asarray(v) for k, v in batch.items()}))(params)
    want = np.asarray(jg["embed"])
    got = g1["embed"].numpy()
    assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()
    assert (np.abs(want).sum(1) > 0).sum() == 24     # the repeated rows
