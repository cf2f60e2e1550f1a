"""Port parity and isolation: the simulation engine end to end, the CLI (the
codec and DP sweeps included), the refusals of what the port does not run
yet, and the rule that the port imports nothing of JAX or of ``repro``.

A ``ci_smoke`` run with the reference's initial parameters injected gives the
reference's ledger slot facts (ks, k_masks, survivors, upload bits) exactly
and accuracies within 0.02 (local SGD differs in the last f32 bits)."""
import dataclasses
import os
import re
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

from repro.core.types import THGSConfig as JTHGS  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.sim import presets as jpresets  # noqa: E402
from repro.sim.engine import Simulation as JSim  # noqa: E402
from repro_torch.core.types import THGSConfig as TTHGS  # noqa: E402
from repro_torch.sim import presets as tpresets  # noqa: E402
from repro_torch.sim.engine import Simulation as TSim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "1"}


def _facts(ledger):
    return [(e.ks, e.k_masks, e.n_clients, e.n_survivors, e.threshold)
            for e in ledger.entries]


@pytest.mark.parametrize("over", [{}, {"dropout_rate": 0.3, "rounds": 2}],
                         ids=["ci_smoke", "ci_smoke_dropout"])
def test_ci_smoke_ledger_and_accuracy_match_reference(over):
    jcfg = jpresets.get("ci_smoke").replace(out_json=None, **over)
    tcfg = tpresets.get("ci_smoke").replace(out_json=None, **over)
    jres = JSim(jcfg).run(resume=False)
    init = jax.tree_util.tree_map(
        np.asarray, jpm.PAPER_MODELS[jcfg.model].init(
            jax.random.key(jcfg.seed)))
    tres = TSim(tcfg, device="cpu", init_params=init).run()
    assert _facts(tres.ledger) == _facts(jres.ledger)
    for acct in ("paper", "tpu"):
        assert tres.ledger.totals(acct) == jres.ledger.totals(acct)
    np.testing.assert_allclose(tres.accuracies, jres.accuracies, atol=0.02)
    if over:
        assert any(e.n_survivors < e.n_clients for e in tres.ledger.entries)
    summary = tres.summary()
    assert summary["config"] == JSim(jcfg).cfg.to_dict() | {"dp": None}
    assert set(summary) == set(jres.summary())


def test_cli_cpu_run_writes_ledger(tmp_path):
    out = tmp_path / "ledger.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim", "--preset", "ci_smoke",
         "--device", "cpu", "--rounds", "1", "--out", str(out)],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=300)
    assert p.returncode == 0, p.stderr
    assert re.search(r"\[paper\] upload .* of FedAvg", p.stdout)
    assert re.search(r"\[tpu  \] upload", p.stdout)
    assert "final_acc=" in p.stdout
    import json

    doc = json.loads(out.read_text())
    assert doc["ledger"]["paper"]["rounds"] == 1
    assert not (tmp_path / "ledger.json.tmp").exists()


def test_cli_without_cuda_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim", "--preset", "ci_smoke"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert "CUDA" in p.stderr and "final_acc" not in p.stdout
    with pytest.raises(RuntimeError, match="CUDA"):
        TSim(tpresets.get("ci_smoke"), device="cuda")


@pytest.mark.parametrize("over,what", [
    ({"thgs": TTHGS(selector="sampled")}, "selector"),
    ({"thgs": TTHGS(selector="local")}, "selector"),
])
def test_config_refuses_what_this_slice_does_not_port(over, what):
    """Nothing here is refused any more: the selector validates as in the
    reference's config, and the round runs it (one ci_smoke round)."""
    cfg = tpresets.get("table2_quick").replace(**over)
    cfg.validate()
    ref = jpresets.get("table2_quick").replace(
        thgs=JTHGS(**dataclasses.asdict(over["thgs"])))
    ref.validate()
    assert getattr(cfg.thgs, what) == getattr(ref.thgs, what)
    res = TSim(tpresets.get("ci_smoke").replace(
        rounds=1, out_json=None, thgs=over["thgs"]), device="cpu").run()
    assert len(res.ledger.entries) == 1


def test_config_accepts_dense_secure_aggregation():
    cfg = tpresets.get("table2_quick").replace(thgs=None)
    assert cfg.sa.enabled
    cfg.validate()


@pytest.mark.parametrize("preset", ["table2_quick", "async_quick"])
def test_config_accepts_checkpoints_sync_and_async(preset):
    tpresets.get(preset).replace(ckpt_dir="ck", ckpt_every=2).validate()


def test_presets_match_reference():
    for name in tpresets.names():
        t = tpresets.get(name).to_dict()
        j = jpresets.get(name).to_dict()
        assert t == j, name
    assert "dp_quick" in tpresets.names()


def _cli(tmp_path, *args):
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim", "--device", "cpu", *args],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def test_cli_codec_sweep_quick_matches_reference_percentages(tmp_path):
    """``--preset codec_sweep_quick --quick`` on the CPU: each quantized
    arm's paper-accounting upload is the reference's share of the f32 arm
    (EXPERIMENTS.md: 27.0% / 22.9% / 19.7%, within 1 point), and the
    combined JSON has all four arms."""
    out = _cli(tmp_path, "--preset", "codec_sweep_quick", "--quick",
               "--out", str(tmp_path / "sweep.json"))
    pct = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[paper\] (int8|int4|1bit) .*\(\s*([\d.]+)% of f32\)", out)}
    want = {"int8": 27.0, "int4": 22.9, "1bit": 19.7}
    assert set(pct) == set(want), out
    for codec, p in want.items():
        assert abs(pct[codec] - p) <= 1.0, (codec, pct[codec])
    import json

    doc = json.loads((tmp_path / "sweep.json").read_text())
    assert list(doc["runs"]) == ["f32", "int8", "int4", "1bit"]
    assert all(r["rounds"] == 3 for r in doc["runs"].values())


def test_cli_dp_quick_prints_reference_epsilon(tmp_path):
    """``--preset dp_quick`` on the CPU composes ε = 40.1 at δ = 1e-5 over
    its 8 noised rounds (the reference's number), with a privacy block in
    the JSON; ``--codec int8`` on a secagg preset turns secagg off."""
    out = _cli(tmp_path, "--preset", "dp_quick", "--out",
               str(tmp_path / "dp.json"))
    m = re.search(r"\[dp   \] eps=([\d.]+) at delta=1e-05 over 8", out)
    assert m and round(float(m.group(1)), 1) == 40.1, out
    import json

    doc = json.loads((tmp_path / "dp.json").read_text())
    assert round(doc["ledger"]["privacy"]["epsilon"], 1) == 40.1
    out = _cli(tmp_path, "--preset", "ci_smoke", "--codec", "int8",
               "--rounds", "1", "--out", str(tmp_path / "c.json"))
    assert "disables secure aggregation" in out and "codec=int8" in out


def test_port_imports_no_jax():
    code = ("import sys, repro_torch, repro_torch.sim, repro_torch.convert, "
            "repro_torch.sim.__main__, repro_torch.sim.profile, "
            "repro_torch.kernels.ops, repro_torch.kernels.build, "
            "repro_torch.kernels.pack, repro_torch.core.dp; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def test_port_sources_never_import_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    pat = re.compile(r"^\s*(import repro(\.|\s|$)|from repro(\.|\s))|"
                     r"^\s*(import jax|from jax)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f
