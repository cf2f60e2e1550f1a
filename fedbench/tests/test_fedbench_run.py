"""A run of each cell end to end on the CPU at a tiny traffic (the chip look
skipped): the last line's schema, ``upload_pct`` counted over the fixed
prefix whatever the window, and ``correct`` coming out false with the timed
path broken underneath, once for each fault a cell can have."""
import json
import math

import pytest
import torch

import run
from fedbench.harness import fl_round, manifest
from repro_torch.core import fedavg
from repro_torch.core import streams as se

CELLS = ("vgg16_table2_secagg", "vgg16_table2_fedavg")
SEED = 2 ** 31 + 977


def tiny(name: str) -> dict:
    cell = manifest.cell(name)
    cell["traffic"] = dict(cell["traffic"], n_train=160, n_clients=4,
                           clients_per_round=2, local_steps=2, local_batch=4,
                           horizon=4, trace_rounds=2)
    return cell


def drive(name: str, seconds: float = 0.0, trace: bool = False) -> dict:
    torch.manual_seed(0)
    cell = tiny(name)
    out = fl_round.run(cell, seed=SEED, seconds=seconds, trace=trace,
                       device="cpu", t_start=0.0)
    return {"out": out, "line": run.result(cell, out, trace=trace,
                                           device="cpu")}


@pytest.fixture(scope="module", params=CELLS)
def sound(request):
    return request.param, drive(request.param)


def test_last_line_schema(sound):
    name, got = sound
    line = json.loads(json.dumps(got["line"]))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    cell = manifest.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    for m in cell["end_to_end"]:
        v = line["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and math.isfinite(v["value"])
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell["workload"]["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_schema():
    got = drive(CELLS[0], seconds=60.0, trace=True)["line"]
    assert list(got) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert got["device"]["window_s"] > 0
    assert set(got["breakdown"]) == {"device_ops", "idle_gaps"}
    assert got["attempted"] == 2
    # host spans read on the CPU; no device metric without a device
    assert "local_sgd_ms.sim" in got["metrics"]
    assert "kernels_roofline_pct.sim" not in got["metrics"]


def test_upload_counts_the_prefix_whatever_the_window():
    short = drive(CELLS[0], seconds=0.0)["out"]
    longer = drive(CELLS[0], seconds=6.0)["out"]
    assert longer["attempted"] > short["attempted"]
    assert longer["metrics"]["upload_pct"] == short["metrics"]["upload_pct"]


def test_upload_pct_on_stub_streams():
    # one leaf of 1,000 elements, 2 clients: k 10 and 4 mask slots a peer,
    # streams of 10 + 2 x 4 slots; 96 bits a slot on the wire towards the
    # one peer, 64 bits an element dense
    leaf = (10, 1000, 2, 18)
    first = [[leaf], [leaf]]
    want = 100.0 * (2 * (10 + 4) * 96) / (2 * 1000 * 64)
    assert fl_round.upload_pct(first, 1000, 2) == pytest.approx(want)
    # the rounds past the prefix are never counted
    later = first + [[(500, 1000, 2, 508)]] * 3
    assert fl_round.upload_pct(later[:2], 1000, 2) == \
        fl_round.upload_pct(first, 1000, 2)


def _unchanged(orig):
    def f(state, *a, **kw):
        old = dict(state.params)
        new = orig(state, *a, **kw)
        new.params = old
        return new
    return f


def _half_batch(orig):
    def f(params, batches, *a, **kw):
        return orig(params, tuple(b[:, :, : b.shape[2] // 2] for b in batches),
                    *a, **kw)
    return f


def _stale_batch(orig):
    # every step after the first trains on the first step's batch
    def f(params, batches, *a, **kw):
        return orig(params, tuple(b[:, :1].expand(b.shape) for b in batches),
                    *a, **kw)
    return f


def _swapped(orig):
    # the round trains each client on the next client's batches
    def f(state, batches, *a, **kw):
        keys = sorted(batches)
        return orig(state, {c: batches[keys[(i + 1) % len(keys)]]
                            for i, c in enumerate(keys)}, *a, **kw)
    return f


def _first_client_only(orig):
    def f(*a, **kw):
        deltas, losses = orig(*a, **kw)
        return {n: torch.cat([d[:1], torch.zeros_like(d[1:])])
                for n, d in deltas.items()}, losses
    return f


def _altered_update(orig):
    def f(*a, **kw):
        deltas, losses = orig(*a, **kw)
        for d in deltas.values():
            d[0].view(-1)[0] += 1.0
        return deltas, losses
    return f


def _first_stream_only(orig):
    def f(streams, **kw):
        return orig(se.StreamBatch(streams.indices[:1], streams.values[:1]),
                    **kw)
    return f


def _altered_stream(orig):
    def f(*a, **kw):
        streams, res = orig(*a, **kw)
        streams.values[0, 0, 0] += 1.0
        return streams, res
    return f


FAULTS = {
    "unchanged": {c: (fedavg, "run_round", _unchanged) for c in CELLS},
    "half_batch": {c: (fedavg, "batched_client_update", _half_batch)
                   for c in CELLS},
    "stale_batch": {c: (fedavg, "batched_client_update", _stale_batch)
                    for c in CELLS},
    "swapped": {c: (fedavg, "run_round", _swapped) for c in CELLS},
    "no_exchange": {
        CELLS[0]: (se, "decode_leaf_batch", _first_stream_only),
        CELLS[1]: (fedavg, "batched_client_update", _first_client_only)},
    "altered": {
        CELLS[0]: (se, "encode_leaf_batch", _altered_stream),
        CELLS[1]: (fedavg, "batched_client_update", _altered_update)},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(sound, fault, monkeypatch):
    name, ok = sound
    mod, attr, wrap = FAULTS[fault][name]
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    line = drive(name)["line"]
    assert line["correct"] is False
    base = ok["line"]["checks"]
    assert any(c["value"] > c["limit"]
               and c["value"] >= 10 * base[k]["value"]
               for k, c in line["checks"].items())


def test_a_tree_of_only_the_benchmark_prints_no_result(tmp_path):
    import shutil
    import subprocess
    import sys
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.BENCH, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_a_limit_on_the_card(name):
    """The plain reference in TF32 put in the program's place reads past at
    least one limit (TF32 exists on the card only)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA device")
    import calibrate
    cell = tiny(name)
    got = calibrate.readings(cell, SEED, False, "cuda:0")["control"]
    limits = cell["workload"]["limits"]
    assert any(got[k] > limits[k] for k in limits)
