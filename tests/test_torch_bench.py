"""Port parity: ``repro_torch.bench``'s schema, gate, timer and CLI against
``repro.bench``, the suites held to RPL002, the committed port baselines,
and the two ``repro.core`` pieces the ``agg`` suite needs — ``masks``'
``pair_mask`` / ``client_masks`` and ``secure_agg.encode_leaf`` — bit-exact
against the reference on shared seeded inputs (every draw and every value
is integer or f32-grid exact: no tolerance)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import lint  # noqa: E402
from repro.bench import schema as jschema  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import secure_agg as jsa  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch.bench import JSON_SUITES, run_suite  # noqa: E402
from repro_torch.bench import schema as tschema  # noqa: E402
from repro_torch.bench import timing  # noqa: E402
from repro_torch.bench.__main__ import main as tmain  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import secure_agg as tsa  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_BASELINES = ("BENCH_round.json", "BENCH_agg.json", "BENCH_cohort.json",
                 "BENCH_serve.json")


def _entry(name, us, reps=2):
    return {"name": name, "us_per_call": us, "reps": reps, "derived": "x"}


def _doc(entries, suite="round", quick=True):
    return tschema.make_doc(entries, suite=suite, quick=quick, device="cpu")


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------- schema
def _docs():
    """The documents of tests/test_bench.py, the four committed reference
    baselines and malformed variants."""
    good = _doc([_entry("round/serial_c8", 100.0)])
    docs = {
        "single": good,
        "combined": tschema.make_doc(
            None, suites={"round": [_entry("round/serial_c8", 1.0)],
                          "agg": [_entry("agg/loop", 2.0)]}, device="cpu"),
        "bad_schema": {"schema": "nope"},
        "duplicate": _doc([_entry("a", 1.0), _entry("a", 2.0)]),
        "nameless": _doc([{"us_per_call": 1.0}]),
        "negative": _doc([_entry("a", -1.0)]),
        "empty": _doc([]),
        "not_object": [1, 2],
        "both_forms": {**good, "suites": {"x": []}},
        "suites_not_object": {**good, "suites": [1]},
        "derived_not_str": _doc([{"name": "a", "us_per_call": 1.0,
                                  "derived": 3}]),
        "no_env": {k: v for k, v in good.items() if k != "env"},
    }
    del docs["suites_not_object"]["entries"]
    del docs["suites_not_object"]["suite"]
    for name in REF_BASELINES:
        with open(ROOT / name) as f:
            docs[name] = json.load(f)
    return docs


DOCS = _docs()


@pytest.mark.parametrize("name", sorted(DOCS))
def test_validate_doc_agrees_with_the_reference(name):
    doc = DOCS[name]
    errs = tschema.validate_doc(doc)
    assert errs == jschema.validate_doc(doc)
    if not errs:
        assert list(tschema.iter_entries(doc)) == \
            list(jschema.iter_entries(doc))


def test_each_package_accepts_the_others_documents():
    port = _doc([_entry("round/serial_c8", 100.0)])
    ref = jschema.make_doc([_entry("round/serial_c8", 100.0)], suite="round",
                           quick=True)
    assert jschema.validate_doc(port) == [] == tschema.validate_doc(ref)
    assert port["schema"] == ref["schema"] == tschema.SCHEMA_VERSION
    env = port["env"]
    assert env["backend"] == "cpu" and env["device_count"] == 1
    assert env["torch"] == torch.__version__
    for key in ("python", "platform", "cuda", "device_name", "power_limit"):
        assert key in env
    assert (tschema.DEFAULT_MAX_SLOWDOWN, tschema.DEFAULT_MIN_US) == (
        jschema.DEFAULT_MAX_SLOWDOWN, jschema.DEFAULT_MIN_US)


GATE_CASES = {
    "within": ([_entry("round/serial_c8", 100.0)],
               [_entry("round/serial_c8", 299.0)], {"max_slowdown": 3.0}),
    "beyond": ([_entry("round/serial_c8", 100.0)],
               [_entry("round/serial_c8", 301.0)], {"max_slowdown": 3.0}),
    "info_and_floor": ([_entry("round/speedup", 0.0), _entry("agg/tiny", 5.0)],
                       [_entry("round/speedup", 0.0),
                        _entry("agg/tiny", 500.0)], {"min_us": 20.0}),
    "unmatched": ([_entry("agg/loop_c32_n65536", 100.0)],
                  [_entry("agg/loop_c8_n16384", 1e9)], {}),
    "tight": ([_entry("a", 100.0), _entry("b", 50.0)],
              [_entry("a", 151.0), _entry("b", 60.0)],
              {"max_slowdown": 1.5}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_compare_agrees_with_the_reference(case):
    base, cur, kw = GATE_CASES[case]
    b, c = _doc(base), _doc(cur)
    assert tschema.gate_compare(c, [b], **kw) == \
        jschema.gate_compare(c, [b], **kw)


@pytest.mark.parametrize("name", REF_BASELINES)
def test_gate_compare_agrees_on_the_reference_baselines(name):
    """Each committed reference baseline gated against all four, and
    against itself slowed 4x: the same failures and counts."""
    docs = [DOCS[n] for n in REF_BASELINES]
    cur = DOCS[name]
    slow = {**cur, "entries": [{**e, "us_per_call": 4 * e["us_per_call"]}
                               for e in cur["entries"]]}
    for c in (cur, slow):
        got = tschema.gate_compare(c, docs)
        assert got == jschema.gate_compare(c, docs)
        assert got[1] > 0
    assert tschema.gate_compare(slow, docs)[0]


def test_measure_returns_min_of_reps(monkeypatch):
    """timing.measure is min-of-single-rep wall clock: a scripted clock with
    one slow rep must not move the result (tests/test_bench.py's pin)."""
    ticks = iter([0.0, 100e-6, 1.0, 1.0 + 10e-6, 2.0, 2.0 + 50e-6])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    calls = []
    us = timing.measure(lambda: calls.append(1), reps=3, warmup=1)
    assert us == pytest.approx(10.0)
    assert len(calls) == 4  # 1 warmup + 3 timed reps


def test_sync_is_a_no_op_on_the_cpu(monkeypatch):
    def boom(*a):
        raise AssertionError("synchronize called for a CPU device")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    timing.sync("cpu")
    timing.sync(torch.device("cpu"))


def test_cli_gate_roundtrip(tmp_path):
    """--gate exit codes: 0 in-budget, 1 on regression, 1 on vacuous gate."""
    base = tmp_path / "base.json"
    base.write_text(json.dumps(_doc([_entry("round/serial_c8", 100.0)])))
    cases = {"ok": ([_entry("round/serial_c8", 120.0)], 0),
             "bad": ([_entry("round/serial_c8", 1e6)], 1),
             "vac": ([_entry("round/other", 1.0)], 1)}
    for name, (entries, rc) in cases.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(_doc(entries)))
        assert tmain(["--gate", str(path), "--baseline", str(base)]) == rc


def test_cli_gate_defaults_to_the_port_baselines():
    assert [f for _, f in JSON_SUITES.values()] == [
        f"BENCH_torch_{s}.json" for s in ("round", "agg", "cohort", "serve")]
    assert not set(f for _, f in JSON_SUITES.values()) & set(REF_BASELINES)


def test_cli_refuses_without_a_card(monkeypatch, capsys):
    """Entry points default to cuda: with no card the run fails loudly
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmain(["--quick", "--only", "cohort", "--out", "never.json"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not os.path.exists("never.json")
    assert tmain(["--quick", "--only", "table1", "--out", "x.json"]) == 2
    assert tmain(["--quick", "--only", "nope"]) == 2


def test_run_suite_unknown_raises():
    with pytest.raises(KeyError):
        run_suite("nope", device="cpu")


@pytest.mark.parametrize("suite", sorted(JSON_SUITES))
def test_port_suites_time_with_min_of_reps(suite):
    """RPL002 (repro/lint/bench_checks.py) scopes itself to
    ``repro/bench/*_bench.py``; each port suite's source, linted under that
    path, must be clean: it times through ``timing.measure`` only."""
    mod = __import__(JSON_SUITES[suite][0], fromlist=["_"])
    with open(mod.__file__) as f:
        src = f.read()
    path = f"src/repro/bench/{os.path.basename(mod.__file__)}"
    findings = lint.lint_source(src, path=path, select={"RPL002"})
    assert [f for f in findings if not f.suppressed] == [], (
        "; ".join(f.message for f in findings))
    bad = src.replace("measure(", "timing.time_us(", 1)
    assert lint.lint_source(bad, path=path, select={"RPL002"})


@pytest.mark.parametrize("suite", ("round", "agg", "cohort", "serve"))
def test_committed_port_baseline(suite):
    """BENCH_torch_<suite>.json: schema-valid for both packages, a --quick
    run recorded on a CUDA card (its name and power limit in the env), with
    at least one gateable entry whose name the reference also uses."""
    with open(ROOT / f"BENCH_torch_{suite}.json") as f:
        doc = json.load(f)
    assert tschema.validate_doc(doc) == [] == jschema.validate_doc(doc)
    assert doc["quick"] and doc["suite"] == suite
    env = doc["env"]
    assert env["backend"] == "cuda" and env["device_count"] >= 1
    assert env["device_name"] and env["power_limit"].endswith(" W")
    assert env["cuda"]
    timed = [e for e in doc["entries"] if e["us_per_call"] > 0]
    assert timed
    with open(ROOT / f"BENCH_{suite}.json") as f:
        ref = {e["name"] for e in json.load(f)["entries"]}
    assert {e["name"] for e in timed} <= ref


# ----------------------------------------------------------- mask helpers
MASK_CASES = [  # (a, b, round, leaf, size, k_mask)
    (0, 1, 0, 0, 1000, 10),
    (3, 1, 2, 5, 4096, 40),
    (2, 5, 1, 3, 65536, 300),
    (7, 4, 9, 53, 159010, 3),
    (1, 2, 0, 1, 17, 64),       # k_mask >> size: indices collide
]


@pytest.mark.parametrize("case", MASK_CASES, ids=str)
def test_pair_mask_bit_exact(case):
    a, b, r, leaf, size, km = case
    ja = jtypes.SecureAggConfig(mask_ratio=0.01, seed=7)
    ta = ttypes.SecureAggConfig(mask_ratio=0.01, seed=7)
    want = jmasks.pair_mask(ja, a, b, r, leaf, size, km)
    got = tmasks.pair_mask(ta, a, b, r, leaf, size, km, device="cpu")
    assert got.indices.dtype == torch.int32
    assert got.values.dtype == torch.float32
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(_bits(got.values), _bits(want.values))
    # the two endpoints: identical support, negated values
    back = tmasks.pair_mask(ta, b, a, r, leaf, size, km, device="cpu")
    assert torch.equal(back.indices, got.indices)
    assert torch.equal(back.values, -got.values)
    if size < km:
        assert len(set(got.indices.tolist())) < km


@pytest.mark.parametrize("client,others,size,km", [
    (1, [0, 1, 2, 3], 300, 5),
    (0, [0, 4, 9], 20, 12),      # colliding support
    (5, [5], 100, 3),            # no peer: empty mask
    (2, [6, 2, 4, 0, 1], 4096, 41),
], ids=str)
def test_client_masks_bit_exact(client, others, size, km):
    ja = jtypes.SecureAggConfig(mask_ratio=0.02, seed=3)
    ta = ttypes.SecureAggConfig(mask_ratio=0.02, seed=3)
    want = jmasks.client_masks(ja, client, others, 4, 2, size, km)
    got = tmasks.client_masks(ta, client, others, 4, 2, size, km,
                              device="cpu")
    assert got.indices.shape == (km * sum(o != client for o in others),)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(_bits(got.values), _bits(want.values))


# ------------------------------------------------------------- encode_leaf
def _leaf_inputs(case: str, seed: int = 0):
    rs = np.random.RandomState(seed)
    shape = (12, 25)
    g = rs.randn(*shape).astype(np.float32)
    r = (0.1 * rs.randn(*shape)).astype(np.float32)
    if case == "ties":
        # equal magnitudes of both signs: top-k must break ties by index
        g = np.round(g * 2) / 2
        r = np.zeros(shape, np.float32)
    return g, r


@pytest.mark.parametrize("case,k,with_mask", [
    ("plain", 7, False), ("plain", 7, True), ("plain", 300, False),
    ("plain", 1000, True), ("ties", 9, False), ("ties", 40, True),
    ("plain", 1, True),
], ids=str)
def test_encode_leaf_bit_exact(case, k, with_mask):
    """Indices, values and the residual (its shape and dtype too) equal the
    reference's, with and without the client's pair masks (their support
    colliding with the top-k), for k >= n and on ties."""
    g, r = _leaf_inputs(case)
    size = g.size
    jmask = tmask = None
    if with_mask:
        ja = jtypes.SecureAggConfig(mask_ratio=0.05, seed=9)
        ta = ttypes.SecureAggConfig(mask_ratio=0.05, seed=9)
        jmask = jmasks.client_masks(ja, 1, [0, 1, 2, 3], 0, 0, size, 40)
        tmask = tmasks.client_masks(ta, 1, [0, 1, 2, 3], 0, 0, size, 40,
                                    device="cpu")
    want = jsa.encode_leaf(jnp.asarray(g), jnp.asarray(r), k,
                           jtypes.THGSConfig(), jmask)
    got = tsa.encode_leaf(torch.from_numpy(g), torch.from_numpy(r), k,
                          ttypes.THGSConfig(), tmask)
    assert got.stream.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.stream.indices.numpy(),
                                  np.asarray(want.stream.indices))
    np.testing.assert_array_equal(_bits(got.stream.values),
                                  _bits(want.stream.values))
    assert got.residual.shape == tuple(want.residual.shape) == g.shape
    assert got.residual.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.residual), _bits(want.residual))


@pytest.mark.parametrize("selector", ["sampled", "local"])
def test_encode_leaf_refuses_unported_selectors(selector):
    """No selector is refused any more: 'sampled' and 'local' encode a leaf
    (with the client's masks, at a size where the sample is strided) bit
    for bit as the reference's."""
    rs = np.random.RandomState(5)
    g = rs.randn(60, 50).astype(np.float32)
    r = (0.1 * rs.randn(60, 50)).astype(np.float32)
    size = g.size
    ja = jtypes.SecureAggConfig(mask_ratio=0.05, seed=9)
    ta = ttypes.SecureAggConfig(mask_ratio=0.05, seed=9)
    jmask = jmasks.client_masks(ja, 1, [0, 1, 2, 3], 0, 0, size, 40)
    tmask = tmasks.client_masks(ta, 1, [0, 1, 2, 3], 0, 0, size, 40,
                                device="cpu")
    want = jsa.encode_leaf(jnp.asarray(g), jnp.asarray(r), 30,
                           jtypes.THGSConfig(selector=selector), jmask)
    got = tsa.encode_leaf(torch.from_numpy(g), torch.from_numpy(r), 30,
                          ttypes.THGSConfig(selector=selector), tmask)
    np.testing.assert_array_equal(got.stream.indices.numpy(),
                                  np.asarray(want.stream.indices))
    np.testing.assert_array_equal(_bits(got.stream.values),
                                  _bits(want.stream.values))
    np.testing.assert_array_equal(_bits(got.residual), _bits(want.residual))


# ----------------------------------------------------------- no JAX inside
def test_bench_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.bench as b\n"
        "import repro_torch.core.secure_agg, repro_torch.core.masks\n"
        "mods = [m.name for m in pkgutil.walk_packages(b.__path__, "
        "'repro_torch.bench.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 12, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro' "
        "or m.startswith(('jax.', 'repro.')))\n"
        "sys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert p.returncode == 0, p.stderr
