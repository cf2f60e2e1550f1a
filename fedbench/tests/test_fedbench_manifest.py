"""BENCHMARK.json keeps to the contract's shape, and the harness finds every
configuration, workload, traffic and metric file by name, a cell added as
data only included."""
import json
import re
import shutil

import pytest

from fedbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return manifest.manifest()


def test_top_level_keys_and_sizes(man):
    assert set(man) == TOP
    assert man["command"] == ["python3", "fedbench/run.py"]
    assert man["paths"] == ["fedbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_entries_have_exactly_the_contract_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"fedbench/configs/{c['name']}.json"
        assert (manifest.ROOT / c["file"]).is_file()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_uniqueness(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        got = [e["name"] for e in man[kind]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert all(UNIT.match(m["unit"]) for m in man["end_to_end"]
               + man["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_the_contract_asks(man):
    for w in man["workloads"]:
        cell = manifest.cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e
    for c in man["configs"]:
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_every_file_is_found_by_name(man):
    for w in man["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["driver"]
        assert set(cell["workload"]["limits"])
    for m in man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_a_cell_added_as_data_is_picked_up(man, tmp_path):
    """A new traffic mix, workload and per-layer metric, files and entries
    only, are found with no edit to the harness."""
    shutil.copytree(manifest.BENCH, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = dict(man)
    w = man["workloads"][0]
    new["workloads"] = man["workloads"] + [dict(
        w, name="dummy_cell", traffic="dummy_mix", why="a test cell")]
    new["per_layer"] = man["per_layer"] + [dict(
        man["per_layer"][0], name="dummy_metric.sim",
        workloads=["dummy_cell"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    bench = tmp_path / "fedbench"
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        dict(traffic, clients_per_round=3)))
    work = json.loads((bench / "workloads" / f"{w['name']}.json").read_text())
    (bench / "workloads" / "dummy_cell.json").write_text(json.dumps(
        dict(work, traffic="dummy_mix")))
    (bench / "metrics" / "dummy_metric.sim.py").write_text(
        "def read(trace, ctx):\n    return 42.0\n")
    cell = manifest.cell("dummy_cell", root=tmp_path)
    assert cell["traffic"]["clients_per_round"] == 3
    assert "dummy_metric.sim" in [m["name"] for m in cell["per_layer"]]
    assert manifest.reader("dummy_metric.sim", root=tmp_path)(None, {}) == 42.0
    other = manifest.cell(w["name"], root=tmp_path)
    assert "dummy_metric.sim" not in [m["name"] for m in other["per_layer"]]


def test_a_workload_file_that_disagrees_with_the_manifest_is_refused(
        man, tmp_path):
    shutil.copytree(manifest.BENCH, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    w = man["workloads"][0]
    path = tmp_path / "fedbench" / "workloads" / f"{w['name']}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    traffic="other")))
    with pytest.raises(ValueError):
        manifest.cell(w["name"], root=tmp_path)
