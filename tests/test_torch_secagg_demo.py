"""Port parity: the secure-aggregation walkthrough
(``repro_torch.secagg.demo``) against the reference's
``examples/secure_aggregation_demo.py``, and ``core/threefry.normal``
against ``jax.random.normal``.

The reference's ``main()`` runs on the CPU under JAX, loaded by path and
not edited, its stdout captured; the port's ``run("cpu")`` and ``main``
give the same five facts. Tolerances: the integer facts (slots, masked
slots, shares, bytes, the DH secret, t) are equal; the printed floats
(first values, share of slots, the unrecovered error, the reduction) equal
to their printed precision; the exactness and recovered errors below 1e-5
(the reference prints 2.38e-07 for both). ``threefry.normal`` is bit-equal
to ``jax.random.normal`` (no tolerance): XLA's f32 ``erf_inv``, its CPU
``log1p`` and ``log`` with their FMAs, and a correctly rounded ``sqrt``.
"""
import importlib.util
import io
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.types import SecureAggConfig as JSecureAggConfig  # noqa: E402
from repro.secagg import RoundProtocol as JRoundProtocol  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.secagg import RoundProtocol, demo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEMO_ERR_TOL = 1e-5

_FACTS = [
    ("dh_secret", r"shared secret (0x[0-9a-f]+)", lambda s: int(s, 16)),
    ("dh_secret_other", r"\(== (0x[0-9a-f]+) from", lambda s: int(s, 16)),
    ("t", r"threshold t=(\d+)", int),
    ("n_phase1_shares", r"\((\d+) shares cross", int),
    ("slots", r"(\d+) slots of \d+", int),
    ("n", r"\d+ slots of (\d+)", int),
    ("share_of_slots", r"slots of \d+ \(([\d.]+%)\)", str),
    ("first_values", r"first 5 values: (\[[^\]]*\])", str),
    ("masked_slots", r"(\d+) slots differ", int),
    ("clear_slots", r"(\d+) top-k slots are", int),
    ("exact_err", r"true_sparse_sum\| = (\S+)", float),
    ("no_recovery_err", r"survivor sum error (\S+) without", str),
    ("recovered_err", r"recovery -> (\S+) after", float),
    ("n_recovery_shares", r"from (\d+) survivor shares", int),
    ("sparse_bytes", r"sparse\+masked = (\d+) B", int),
    ("share_bytes", r"\(\+ (\d+) B Shamir", int),
    ("dense_bytes", r"dense Bonawitz = (\d+) B", int),
    ("reduction", r"-> ([\d.]+)x reduction", str),
]


def _parse(text: str) -> dict:
    out = {}
    for name, pattern, cast in _FACTS:
        m = re.search(pattern, text)
        assert m, f"{name} not printed:\n{text}"
        out[name] = cast(m.group(1))
    return out


@pytest.fixture(scope="module")
def reference_stdout() -> str:
    spec = importlib.util.spec_from_file_location(
        "secure_aggregation_demo", ROOT / "examples" /
        "secure_aggregation_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


@pytest.fixture(scope="module")
def port_facts() -> dict:
    return demo.run("cpu")


def test_printed_facts_equal_the_reference(reference_stdout, capsys):
    assert demo.main(["--device", "cpu"]) == 0
    port = _parse(capsys.readouterr().out)
    ref = _parse(reference_stdout)
    for name in ("exact_err", "recovered_err"):
        assert port.pop(name) < DEMO_ERR_TOL
        assert ref.pop(name) < DEMO_ERR_TOL
    assert port == ref


def test_run_returns_the_printed_facts(reference_stdout, port_facts):
    ref = _parse(reference_stdout)
    f = port_facts
    for name in ("dh_secret", "dh_secret_other", "t", "n_phase1_shares",
                 "slots", "n", "masked_slots", "clear_slots",
                 "n_recovery_shares", "sparse_bytes", "share_bytes",
                 "dense_bytes"):
        assert f[name] == ref[name], name
    assert (f["slots"], f["masked_slots"], f["k"], f["k_mask"]) == (
        162, 81, 81, 27)
    assert str(f["first_values"].round(3)) == ref["first_values"]
    assert f"{f['no_recovery_err']:.2f}" == ref["no_recovery_err"]
    assert f"{f['reduction']:.1f}" == ref["reduction"]
    assert f["exact_err"] < DEMO_ERR_TOL and f["recovered_err"] < DEMO_ERR_TOL
    assert f["no_recovery_err"] > 0.5      # the unpaired masks stay


def test_decoded_sums_and_streams(port_facts):
    f = port_facts
    assert f["indices"].shape == f["values"].shape == (3, 1, 162)
    for name in ("dense", "dense_drop", "dense_no_recovery"):
        assert f[name].shape == (4096,) and torch.isfinite(f[name]).all()
    # recovery cancels bank 2's unpaired masks: the survivors' sum is what
    # the no-recovery decode leaves once they are gone
    assert not torch.equal(f["dense_drop"], f["dense_no_recovery"])
    # on the CPU the plain versions run: no kernel is launched
    assert set(f["launches"].values()) == {0}


def test_runs_bit_identically_twice(port_facts):
    again = demo.run("cpu")
    for name in ("indices", "values", "dense", "dense_drop",
                 "dense_no_recovery"):
        assert torch.equal(again[name], port_facts[name]), name


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the walkthrough runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo.run("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo.main([])


def test_protocol_share_counts_equal_the_reference():
    for C in (2, 3, 5, 8):
        port = RoundProtocol.setup(demo.SA, list(range(C)), round_t=0)
        ref = JRoundProtocol.setup(
            JSecureAggConfig(mask_ratio=0.02, seed=2024), list(range(C)),
            round_t=0)
        assert port.n_phase1_shares == ref.n_phase1_shares == C * (C - 1)
        for d in range(C):
            assert port.n_recovery_shares(d) == ref.n_recovery_shares(d)


def test_gradients_are_the_references():
    key = jax.random.key(7)
    want = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, b), (4096,))) for b in demo.BANKS])
    got = demo.gradients().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------- threefry.normal
@pytest.mark.parametrize("shape", [(1,), (3,), (7,), (4096,), (3, 5),
                                   (257, 33), (200003,)])
@pytest.mark.parametrize("seed", [0, 7, 42, 2 ** 31 - 2, 123456789])
def test_normal_is_bit_equal(seed, shape):
    for d in (0, 1, 2):
        want = np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.key(seed), d), shape))
        got = threefry.normal(threefry.fold_in(threefry.key(seed), d),
                              shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_normal_batched_keys_match_vmap():
    ks = jax.random.split(jax.random.key(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (5, 7)))(ks))
    keys = torch.from_numpy(
        np.asarray(jax.random.key_data(ks)).astype(np.int64))
    got = threefry.normal(keys, (5, 7)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _erf_inv_inputs() -> np.ndarray:
    rs = np.random.RandomState(0)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = rs.uniform(-1, 1, 300000).astype(np.float32)
    # the tails, where w = -log1p(-u^2) >= 5 takes the sqrt branch, and the
    # log1p branch point |u^2| = sqrt(2) - 1
    tail = (1 - rs.uniform(0, 0.0067, 100000)).astype(np.float32)
    edge = np.float32(np.sqrt(np.sqrt(2) - 1)) + (
        rs.randint(-50, 50, 2000).astype(np.float32) * np.float32(2 ** -24))
    return np.concatenate([u, tail, -tail, edge, -edge,
                           np.float32([0.0, -0.0, lo, 1e-30, -1e-30,
                                       0.5, -0.5])])


def test_erf_inv_is_xla_bit_for_bit():
    """XLA's f32 ``erf_inv`` (Giles' polynomial on XLA's CPU ``log1p``)
    across the domain, its tails and the ``log1p`` branch point."""
    u = _erf_inv_inputs()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    got = threefry.erf_inv(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_erf_inv_differs_from_torch_erfinv():
    """Why ``torch.erfinv`` is not used: it rounds otherwise than XLA on
    some of these inputs, where the port's route is bit-equal (the test
    above). The tail's ``sqrt`` goes through f64, correctly rounded as
    XLA's is (PyTorch's f32 ``sqrt`` on the CPU was measured 0.556 ulp off
    at worst)."""
    u = _erf_inv_inputs()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u)).view(np.int32)
    assert (torch.erfinv(torch.from_numpy(u)).numpy().view(np.int32)
            != want).any()
    w = np.random.RandomState(1).uniform(5, 17, 200000).astype(np.float32)
    xla = np.asarray(jax.jit(jnp.sqrt)(w)).view(np.int32)
    f64 = torch.sqrt(torch.from_numpy(w).double()).float().numpy()
    np.testing.assert_array_equal(f64.view(np.int32), xla)
