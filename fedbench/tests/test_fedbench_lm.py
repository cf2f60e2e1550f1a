"""The LM cell end to end on the CPU at a tiny width (the chip look
skipped): the last line's schema, and ``correct`` coming out false with the
timed step broken underneath, once for each fault a one-chip dense step can
have (no exchange between chips)."""
import time

import pytest
import torch

import run
from fedbench.harness import lm_step, manifest
from repro_torch.launch import train

CELL = "yi6b_dense_train"


def tiny() -> dict:
    cell = manifest.cell(CELL)
    cell["config"] = dict(cell["config"], n_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=2, d_ff=128, vocab=256)
    cell["traffic"] = dict(cell["traffic"], batch=2, seq=32)
    return cell


def drive(trace=False, seconds=0.0) -> dict:
    cell = tiny()
    out = lm_step.run(cell, seed=2 ** 31 + 5, seconds=seconds, trace=trace,
                      device="cpu", t_start=time.perf_counter())
    return run.result(cell, out, trace=trace, device="cpu")


@pytest.fixture(scope="module")
def sound():
    return drive()


def test_schema_and_sound_run(sound):
    assert sound["correct"] is True
    assert set(sound["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                     "setup_s"}
    assert list(sound["checks"]) == ["loss_gap", "grad_gap", "change_gap"]
    traced = drive(trace=True, seconds=60.0)
    assert traced["attempted"] == 2
    assert set(traced["metrics"]) <= {"device_idle_pct.lm", "mfu.lm"}


def _unchanged(orig):
    def f(params, grads, lr):
        return None
    return f


def _half_batch(orig):
    def f(params, cfg, batch, n_micro=1):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(params, cfg, half, n_micro=1)
    return f


def _altered(orig):
    def f(*a, **kw):
        value, grads = orig(*a, **kw)
        for g in grads.values():
            g.view(-1)[0] += 1.0
        return value, grads
    return f


FAULTS = {"unchanged": ("sgd_update", _unchanged),
          "half_batch": ("step_gradients", _half_batch),
          "altered": ("step_gradients", _altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(sound, fault, monkeypatch):
    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(train, attr, wrap(getattr(train, attr)))
    line = drive()
    assert line["correct"] is False
    assert any(c["value"] > c["limit"]
               and c["value"] >= 10 * sound["checks"][k]["value"]
               for k, c in line["checks"].items())


def test_the_weights_are_a_pure_function_of_the_seed():
    cell = tiny()
    a = lm_step.weights(cell["config"], 12345, "cpu")
    b = lm_step.weights(cell["config"], 12345, "cpu")
    c = lm_step.weights(cell["config"], 12346, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], c["embed"])
    x = lm_step.batch(cell["config"], cell["traffic"], 3, 7, "cpu")
    y = lm_step.batch(cell["config"], cell["traffic"], 3, 7, "cpu")
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])


def test_the_fp8_control_fails_a_limit():
    """The reference with float8 projections put in the step's place reads
    past at least one limit, at a size a test run holds (the cell's own
    readings are taken on the card by ``fedbench/calibrate.py``)."""
    cell = tiny()
    ref = lm_step.follow(cell["config"], cell["traffic"], 99, "cpu")
    ctl = lm_step.follow(cell["config"], cell["traffic"], 99, "cpu",
                         prec="fp8")
    got = lm_step.compare(ctl, ref)
    limits = cell["workload"]["limits"]
    assert any(got[k] > limits[k] for k in limits)
