"""Port parity: the loose ends of ``repro_torch.core`` against
``repro.core`` — the single-client ``client_update``, Eq. 7's
``total_upload_to_convergence``, ``SparseStream``, ``tree_size``,
``tree_zeros_like`` and the package's re-exported surface.

``client_update`` runs local SGD in f32 like the batched program: deltas
and the loss within rtol=1e-5, atol=1e-6 of the reference's (f32 matmuls
summed in another order), the tolerance of ``test_torch_fedavg.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each keeps
# PyTorch's thread pools from oversubscribing them (no result here depends
# on the thread count)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core import fedavg as jfa  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core import fedavg as tfa  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _params(seed=0):
    jp = jpm.PAPER_MODELS["mnist_mlp"].init(jax.random.key(seed))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tp = {".".join(k.key for k in path): torch.from_numpy(np.array(v))
          for path, v in flat}
    return jp, tp, flat


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_client_update_within_tolerance_of_reference(prox_mu):
    jp, tp, _ = _params()
    rs = np.random.RandomState(3)
    x = rs.randn(3, 8, 28, 28, 1).astype(np.float32)
    y = rs.randint(0, 10, (3, 8)).astype(np.int32)
    jd, jl = jfa.client_update(
        jp, (jnp.asarray(x), jnp.asarray(y)),
        jpm.cross_entropy_loss(jpm.PAPER_MODELS["mnist_mlp"]), 3, 0.05,
        prox_mu)
    td, tl = tfa.client_update(
        tp, (torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))),
        tpm.cross_entropy_loss(tpm.build_model("mnist_mlp")), 3, 0.05,
        prox_mu)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    for path, v in jax.tree_util.tree_flatten_with_path(jd)[0]:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(td[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_rounds,per_round", [(0, 5), (30, 123456789),
                                                (1, 0), (7, 2 ** 40)])
def test_total_upload_to_convergence_matches_reference(n_rounds, per_round):
    assert tcosts.total_upload_to_convergence(n_rounds, per_round) == \
        jcosts.total_upload_to_convergence(n_rounds, per_round)


def test_sparse_stream_and_tree_helpers_match_reference():
    jp, tp, flat = _params(1)
    assert ttypes.tree_size(tp) == jtypes.tree_size(jp) == 159010
    nested = {"a": tp, "b": [tp["l0.b"], (tp["l1.b"],)]}
    assert ttypes.tree_size(nested) == 159010 + 200 + 10
    for dtype in (None, torch.bfloat16):
        z = ttypes.tree_zeros_like(tp, dtype)
        jz = jtypes.tree_zeros_like(jp, None if dtype is None
                                    else jnp.bfloat16)
        for path, v in jax.tree_util.tree_flatten_with_path(jz)[0]:
            name = ".".join(k.key for k in path)
            assert tuple(z[name].shape) == tuple(v.shape)
            assert str(z[name].dtype).split(".")[-1] == str(v.dtype)
            assert not z[name].any()
    zn = ttypes.tree_zeros_like(nested)
    assert isinstance(zn["b"], list) and isinstance(zn["b"][1], tuple)
    idx = np.arange(7, dtype=np.int32)
    vals = np.linspace(-1, 1, 7, dtype=np.float32)
    ts = ttypes.SparseStream(torch.from_numpy(idx), torch.from_numpy(vals))
    js = jtypes.SparseStream(jnp.asarray(idx), jnp.asarray(vals))
    assert ts.k == js.k == 7
    with pytest.raises(Exception):
        ts.k = 3                                        # frozen


def test_core_package_reexports_the_ported_surface():
    assert tcore.__all__ and set(tcore.__all__) <= set(jcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    assert tcore.client_update is tfa.client_update
    assert tcore.streams.encode_leaf_batch is tcore.encode_leaf_batch
    code = ("import sys; from repro_torch.core import *; "
            "import repro_torch.secagg.protocol; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert p.returncode == 0, p.stderr
