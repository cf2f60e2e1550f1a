"""The port's bench suites on the CPU at their ``--quick`` sizes: each JSON
suite runs, its document validates in both packages, and its entry names
equal the reference's committed quick names (one entry name, one workload,
in both packages); the cohort suite's tree == flat guard; the paper-table
drivers: ``table1`` in full against the reference's rows,
``SimResult.rounds_to_reach`` against ``repro.sim``'s, and ``table2`` / ``fig1`` / ``fig3`` building
``SimConfig``s equal field for field to ``benchmarks/common.sim_config``'s,
run for run and row name for row name (nothing is simulated here).

Times taken here are CPU times: no test reads them."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.bench import schema as jschema  # noqa: E402
from repro_torch.bench import JSON_SUITES, run_suite  # noqa: E402
from repro_torch.bench import schema as tschema  # noqa: E402
from repro_torch.bench.__main__ import main as tmain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the repo-root ``benchmarks`` package
    sys.path.insert(0, str(ROOT))

# the single-device rows of BENCH_round.json (the reference's committed
# run forced 8 host devices; one card has no sharded round to time)
ROUND_QUICK = ["round/model_size_c8", "round/serial_c8",
               "round/serial_dropout_c8", "round/sharded_c8"]


def _ref_quick_names(suite: str) -> list[str]:
    if suite == "round":
        return ROUND_QUICK
    with open(ROOT / f"BENCH_{suite}.json") as f:
        return [e["name"] for e in json.load(f)["entries"]]


@pytest.mark.parametrize("suite", sorted(JSON_SUITES))
def test_json_suite_runs_with_the_reference_names(suite):
    entries = run_suite(suite, quick=True, device="cpu")
    names = [e["name"] for e in entries]
    assert names == _ref_quick_names(suite)
    doc = tschema.make_doc(entries, suite=suite, quick=True, device="cpu")
    assert tschema.validate_doc(doc) == [] == jschema.validate_doc(doc)
    assert doc["env"]["backend"] == "cpu"
    assert any(e["us_per_call"] > 0 for e in entries)
    for e in entries:
        assert e["us_per_call"] >= 0 and isinstance(e["derived"], str)
    if suite == "round":
        with open(ROOT / "BENCH_round.json") as f:
            ref = {e["name"] for e in json.load(f)["entries"]}
        assert set(names[:3]) <= ref
        assert entries[0]["derived"] == "159010_params_mnist_mlp"
        assert entries[3] == {"name": "round/sharded_c8", "us_per_call": 0.0,
                              "derived": "unavailable_single_device"}


def test_cohort_guard_holds_and_fires(monkeypatch):
    """The tree == flat guard passes on the real decode and stops the suite
    before any timing when the tree decode is wrong."""
    from repro_torch.bench import cohort_bench
    from repro_torch.core import streams

    assert len(cohort_bench._one_cohort(64, 1 << 10, 4, 1, "cpu")) == 3
    real = streams.decode_sum_tree
    monkeypatch.setattr(streams, "decode_sum_tree",
                        lambda *a, **kw: real(*a, **kw) + 1.0)
    with pytest.raises(AssertionError, match="diverged"):
        cohort_bench._one_cohort(64, 1 << 10, 4, 1, "cpu")


def test_cli_writes_per_suite_and_combined_documents(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tmain(["--device", "cpu", "--quick", "--only", "cohort"]) == 0
    doc = tschema.load_doc("BENCH_torch_cohort.json")
    assert doc["suite"] == "cohort" and doc["quick"]
    assert jschema.validate_doc(doc) == []
    assert tmain(["--device", "cpu", "--quick", "--only", "cohort", "--out",
                  "all.json"]) == 0
    combined = tschema.load_doc("all.json")
    assert list(combined["suites"]) == ["cohort"]
    # a fresh run gated against the document just written: in budget
    assert tmain(["--gate", "all.json", "--baseline",
                  "BENCH_torch_cohort.json", "--max-slowdown", "1e6"]) == 0
    assert not list(tmp_path.glob("*.tmp"))


def test_table1_in_full():
    """The port's Table 1 rows carry the reference's names and derived
    strings (parameter counts, both volume accountings), row for row."""
    import benchmarks.table1_model_sizes as jtable1
    from repro_torch.bench.paper import table1
    from repro_torch.models.paper_models import TABLE1_PARAMS

    rows = table1.run(quick=False, device="cpu")
    assert [r[0] for r in rows] == [f"table1/{n}" for n in TABLE1_PARAMS]
    for (name, us, derived), n in zip(rows, TABLE1_PARAMS.values()):
        assert us > 0 and f"params={n};published={n};match=True" in derived
    jrows = jtable1.run(quick=False)
    assert [(r[0], r[2]) for r in rows] == [(r[0], r[2]) for r in jrows]


@pytest.mark.parametrize("accs,eval_every,target", [
    ([0.1, 0.5, 0.9, 0.95], 1, 0.9),
    ([0.1, 0.5, 0.9, 0.95], 3, 0.9),
    ([0.2, 0.4], 2, 0.4),
    ([0.2, 0.4], 2, 0.99),
    ([], 1, 0.5),
    ([0.3, 0.6], 0, 0.6),
], ids=["reached", "eval_every3", "reached_exactly", "never", "no_evals",
        "eval_every0"])
def test_rounds_to_reach_equals_the_reference(accs, eval_every, target):
    """``SimResult.rounds_to_reach`` (what ``table2`` costs its rows by)
    equals ``repro.sim``'s on the same accuracies and eval cadence."""
    import dataclasses

    from repro.sim.engine import SimResult as JResult
    from repro_torch.sim.engine import SimResult as TResult

    def make(cls):
        kw = {f.name: None for f in dataclasses.fields(cls)}
        kw.update(accuracies=list(accs), eval_every=eval_every)
        return cls(**kw)

    assert (make(TResult).rounds_to_reach(target)
            == make(JResult).rounds_to_reach(target))


def test_table1_csv_rows(capsys):
    assert tmain(["--csv", "--only", "table1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in out[1:]] == [
        "table1/mnist_mlp", "table1/mnist_cnn", "table1/cifar_mlp",
        "table1/cifar_vgg16"]


class _FakeLedger:
    def upload_bits_through(self, n, accounting="paper"):
        return 1000 * n

    def totals(self, accounting="paper"):
        return {"compression_x": 2.0}


class _FakeResult:
    """What the drivers read from a run, with no run behind it."""

    def __init__(self, cfg):
        self.rounds = cfg.rounds
        self.accuracies = [0.5] * (cfg.rounds // cfg.eval_every)
        self.final_acc = 0.5
        self.wall_s = 1.0
        self.ledger = _FakeLedger()

    def rounds_to_reach(self, target):
        return None


def _record(module, common, calls: list):
    """A stand-in for ``module.simulate`` recording each run's SimConfig."""
    def simulate(model_name="mnist_mlp", dataset="mnist", **protocol):
        protocol.pop("device", None)
        cfg = common.sim_config(model_name, dataset, **protocol)
        calls.append(cfg)
        return _FakeResult(cfg)

    return simulate


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("driver,ref_module", [
    ("table2", "benchmarks.table2_comm_cost"),
    ("fig1", "benchmarks.fig1_sparsity_accuracy"),
    ("fig3", "benchmarks.fig3_thgs_vs_flat"),
])
def test_paper_driver_configs_equal_the_reference(monkeypatch, driver,
                                                   ref_module, quick):
    import importlib

    import benchmarks.common as jcommon
    from repro_torch.bench.paper import common as tcommon

    jmod = importlib.import_module(ref_module)
    tmod = importlib.import_module(f"repro_torch.bench.paper.{driver}")
    jcalls, tcalls = [], []
    monkeypatch.setattr(jmod, "simulate", _record(jmod, jcommon, jcalls))
    monkeypatch.setattr(tmod, "simulate", _record(tmod, tcommon, tcalls))
    jrows = jmod.run(quick=quick)
    trows = tmod.run(quick=quick, device="cpu")
    assert tcalls and len(tcalls) == len(jcalls)
    for t, j in zip(tcalls, jcalls):
        assert type(t).__module__.startswith("repro_torch.")
        assert t.to_dict() == j.to_dict()
        t.validate()
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert trows == jrows
