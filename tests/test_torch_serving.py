"""Port parity: the LM serving path (``InferenceServer`` + ``LMAdapter``
driven by ``LoadGenerator``), its metrics document, the ``serve_llm`` entry
point, hot swap from published checkpoints (``CheckpointWatcher``) and the
train+serve CLI, and the rule that the serving modules import nothing of JAX
or of ``repro``.

The responses are held to the port's own ``greedy_generate`` token for
token (the model's parity with the reference is ``tests/test_torch_lm.py``);
the metrics document must pass both packages' validators. The hot-swap tests
mirror the reference's ``tests/test_serving.py``: logits after a swap are
bit-identical to a cold server restored from the same step, and a crash
mid-publish leaves the server on the last good step. Every join and wait has
a time limit.
"""
import dataclasses
import io
import os
import shutil
import time
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

from repro.serving import metrics as jmetrics  # noqa: E402
from repro_torch import checkpoint, configs, serving  # noqa: E402
from repro_torch.data import make_lm_tokens  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.paper_models import build_model  # noqa: E402
from repro_torch.serving import serve_llm  # noqa: E402

ENV = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1]
                                       / "src"), "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def yi():
    cfg = configs.reduced(configs.get("yi_6b"))
    model = tf.init_params(cfg, torch.Generator().manual_seed(0))
    prompts, _ = make_lm_tokens(cfg.vocab, 8, 12, seed=3)
    return cfg, model, np.asarray(prompts, np.int32)


def test_lm_server_under_load_serves_greedy_tokens(yi):
    cfg, model, prompts = yi
    metrics = serving.ServingMetrics(offered_qps=200.0)
    adapter = serving.LMAdapter(cfg, max_batch=4, prompt_len=12, n_new=4)
    server = serving.InferenceServer(adapter, model, metrics=metrics)
    gen = serving.LoadGenerator(server, prompts, 200.0, metrics=metrics)
    server.start()
    try:
        assert gen.run(n_requests=8) == 8
        tickets = list(gen._tickets)
        assert gen.drain() == 0
    finally:
        server.stop()
    for prompt, ticket in zip(prompts, tickets):
        got = ticket.wait(0)
        want = greedy_generate(model, cfg, torch.from_numpy(prompt[None]), 4,
                               adapter.cache_len)
        assert got.dtype == np.int32 and got.shape == (4,)
        np.testing.assert_array_equal(got, want[0].numpy())
    doc = metrics.summary()
    assert doc["requests"] == {"submitted": 8, "served": 8, "errors": 0}
    assert doc["tokens"]["generated"] == 32
    assert serving.validate_metrics(doc) == []
    assert jmetrics.validate_metrics(doc) == []


def test_metrics_document_written_atomically_reads_in_both_packages(
        yi, tmp_path):
    cfg, model, prompts = yi
    adapter = serving.LMAdapter(cfg, max_batch=2, prompt_len=12, n_new=2)
    server = serving.InferenceServer(adapter, model)
    tickets = [server.submit(p) for p in prompts[:3]]
    assert server.drain() == 3
    assert all(t.wait(0).shape == (2,) for t in tickets)
    path = server.metrics.to_json(str(tmp_path / "m" / "serve.json"))
    assert serving.load_metrics(path) == jmetrics.load_metrics(path)
    assert not (tmp_path / "m" / "serve.json.tmp").exists()
    assert serving.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION


def test_adapter_error_is_recorded_and_counts_reconcile(yi):
    cfg, model, prompts = yi
    adapter = serving.LMAdapter(cfg, max_batch=2, prompt_len=12, n_new=2)
    server = serving.InferenceServer(adapter, model)
    bad = server.submit(np.full(12, cfg.vocab + 5, np.int32))   # bad token
    assert server.step() == 1                 # the loop survives the error
    with pytest.raises(IndexError):
        bad.wait(1.0)
    doc = server.metrics.summary()
    assert doc["requests"]["errors"] == 1
    assert serving.validate_metrics(doc) == []


def test_classifier_adapter_serves_model_logits():
    model = build_model("mnist_mlp").init_(torch.Generator().manual_seed(1))
    params = model.params()
    x = np.random.RandomState(0).randn(3, *model.input_shape).astype(
        np.float32)
    server = serving.InferenceServer(serving.ClassifierAdapter(model, 4),
                                     params)
    tickets = [server.submit(row) for row in x]
    assert server.step() == 3
    want = model.apply(params, torch.from_numpy(x)).detach().numpy()
    got = np.stack([t.wait(0) for t in tickets])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unported_parts_are_refused(yi):
    """The LM families are served now (slice G2a lifted their refusals):
    what the adapter refuses is a dtype the port has no path for; an
    encoder-only model, whose decode step raises as the reference's does,
    fails its batch, recorded as an error."""
    cfg, _, prompts = yi
    moe = configs.reduced(configs.get("deepseek_moe_16b"))
    serving.LMAdapter(moe, max_batch=2, prompt_len=12, n_new=2)
    with pytest.raises(ValueError, match="dtype"):
        serving.LMAdapter(dataclasses.replace(cfg, dtype="float16"),
                          max_batch=2, prompt_len=12, n_new=2)
    hubert = configs.reduced(configs.get("hubert_xlarge"))
    server = serving.InferenceServer(
        serving.LMAdapter(hubert, max_batch=2, prompt_len=12, n_new=2),
        tf.init_params(hubert, torch.Generator().manual_seed(0)))
    ticket = server.submit(prompts[0])
    assert server.step() == 1
    with pytest.raises(Exception):
        ticket.wait(1.0)
    assert server.metrics.summary()["requests"]["errors"] == 1


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "zamba2_7b",
                                  "xlstm_125m"])
def test_lm_families_served_greedy_tokens(arch):
    """MoE, the hybrid and xLSTM through the adapter: each response is the
    greedy loop's tokens for its prompt."""
    cfg = configs.reduced(configs.get(arch))
    model = tf.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.asarray(make_lm_tokens(cfg.vocab, 3, 12, seed=4)[0],
                         np.int32)
    adapter = serving.LMAdapter(cfg, max_batch=2, prompt_len=12, n_new=3)
    server = serving.InferenceServer(adapter, model)
    tickets = [server.submit(p) for p in prompts]
    assert server.drain() == 3
    for prompt, ticket in zip(prompts, tickets):
        want = greedy_generate(model, cfg, torch.from_numpy(prompt[None]), 3,
                               adapter.cache_len)
        np.testing.assert_array_equal(ticket.wait(0), want[0].numpy())


def test_weight_buffers_swap_between_batches():
    a = {"w": torch.zeros(2)}
    b = {"w": torch.ones(2)}
    buf = serving.WeightBuffers(a, step=1)
    assert buf.staged_step is None and not buf.has_staged
    with pytest.raises(RuntimeError):
        buf.swap()
    buf.stage(2, b)
    assert buf.active_params is a and buf.staged_step == 2
    assert buf.swap() >= 0.0
    assert buf.active_params is b and buf.active_step == 2
    assert not buf.has_staged


def test_serve_llm_entry_point_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve_llm.main(["--device", "cpu", "--requests", "4",
                             "--n-new", "3", "--qps", "200"])
    text = out.getvalue()
    assert rc == 0, text
    assert "arch=yi-6b (reduced)  max_batch=4 prompt=24 new=3" in text
    assert "12 tokens for 4 requests" in text and "0 errors" in text
    assert text.count("-> generated=") == 4


def test_serve_llm_serves_a_moe_model_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve_llm.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                             "--requests", "4", "--n-new", "3", "--qps",
                             "200"])
    text = out.getvalue()
    assert rc == 0, text
    assert "arch=deepseek-moe-16b (reduced)" in text
    assert "12 tokens for 4 requests" in text and "0 errors" in text


def test_serve_llm_refuses_the_encoder_only_model():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_llm.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_serve_llm_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert serve_llm.main(["--requests", "1"]) == 1


def test_serving_modules_import_no_jax():
    code = ("import sys, repro_torch.serving.server, "
            "repro_torch.serving.serve_llm, repro_torch.models.transformer, "
            "repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.configs, repro_torch.kernels.flash_attention; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


# ------------------------------------------------------------- hot swap
MLP = build_model("mnist_mlp")


def _mlp_params(seed: int) -> dict:
    model = build_model("mnist_mlp").init_(torch.Generator().manual_seed(seed))
    return {n: p.detach().clone() for n, p in model.params().items()}


def _payload(seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*MLP.input_shape).astype(
        np.float32)


def _served_logits(server, payload) -> np.ndarray:
    t = server.submit(payload)
    server.step(block=True)
    return np.asarray(t.wait(30.0))


def test_hot_swap_logits_bit_identical_to_a_cold_restore(tmp_path):
    d = str(tmp_path)
    p1, p2 = _mlp_params(1), _mlp_params(2)
    checkpoint.publish(d, 1, p1)
    x = _payload()
    metrics = serving.ServingMetrics()
    buffers = serving.WeightBuffers(p1, step=1)
    watcher = serving.CheckpointWatcher(d, p1, buffers, metrics=metrics)
    server = serving.InferenceServer(serving.ClassifierAdapter(MLP, 4),
                                     watcher=watcher, metrics=metrics)
    before = _served_logits(server, x)
    checkpoint.publish(d, 2, p2)          # the trainer finishes round 2
    assert watcher.poll_once() == 2       # staged off the serve path
    assert watcher.last_stage["step"] == 2
    assert buffers.active_step == 1       # the old weights still serve
    after = _served_logits(server, x)     # step() swaps between batches
    assert buffers.active_step == 2
    assert metrics.swap_steps == [2]
    assert watcher.poll_once() is None    # nothing newer
    cold = serving.InferenceServer(serving.ClassifierAdapter(MLP, 4),
                                   checkpoint.restore(d, 2, like=p1))
    expect = _served_logits(cold, x)
    assert after.tobytes() == expect.tobytes()       # bit-identical
    assert before.tobytes() != after.tobytes()       # and really swapped


def test_truncated_or_missing_manifest_keeps_the_last_good_step(tmp_path):
    d = str(tmp_path)
    p1, p2 = _mlp_params(1), _mlp_params(2)
    checkpoint.publish(d, 1, p1)
    buffers = serving.WeightBuffers(p1, step=0)
    watcher = serving.CheckpointWatcher(d, p1, buffers)
    assert watcher.poll_once() == 1
    assert watcher.maybe_swap() == 1
    assert watcher.maybe_swap() is None
    # crash A: manifest truncated mid-dump (bypassing tmp + replace)
    checkpoint.publish(d, 2, p2)
    with open(os.path.join(d, "step_00000002.json"), "w") as f:
        f.write('{"step": 2, "lea')
    # crash B: the npz written, the manifest never
    shutil.copy(os.path.join(d, "step_00000002.npz"),
                os.path.join(d, "step_00000003.npz"))
    assert watcher.poll_once() is None
    assert watcher.maybe_swap() is None
    assert buffers.active_step == 1       # still on the last good step
    checkpoint.publish(d, 2, p2)          # the trainer retries
    assert watcher.poll_once() == 2
    assert watcher.maybe_swap() == 2
    assert buffers.active_step == 2       # never goes back


def test_server_needs_params_or_a_watcher():
    with pytest.raises(ValueError, match="params or a watcher"):
        serving.InferenceServer(serving.ClassifierAdapter(MLP, 2))


def test_watcher_thread_retries_a_lost_race_and_staleness_is_filled(
        tmp_path):
    d = str(tmp_path)
    p1, p2 = _mlp_params(1), _mlp_params(2)
    checkpoint.publish(d, 1, p1)
    calls = []

    def racing_restore(step):
        calls.append(step)
        if len(calls) == 1:               # the reader loses one race
            raise KeyError("checkpoint missing leaf (racing the publisher)")
        return checkpoint.restore(d, step, like=p1)

    metrics = serving.ServingMetrics()
    buffers = serving.WeightBuffers(p1, step=1)
    watcher = serving.CheckpointWatcher(d, p1, buffers, metrics=metrics,
                                        restore_fn=racing_restore,
                                        poll_interval_s=0.01)
    server = serving.InferenceServer(serving.ClassifierAdapter(MLP, 2),
                                     watcher=watcher, metrics=metrics)
    checkpoint.publish(d, 2, p2)
    with pytest.raises(KeyError):
        watcher.poll_once()
    assert watcher.latest_seen == 2 and buffers.active_step == 1
    _served_logits(server, _payload())    # step 1 serves, step 2 is out
    watcher.start()
    try:
        deadline = time.perf_counter() + 10.0
        while not buffers.has_staged and time.perf_counter() < deadline:
            time.sleep(0.01)
    finally:
        watcher.stop()
    assert watcher._thread is None        # joined within its time limit
    assert buffers.has_staged and calls == [2, 2]
    _served_logits(server, _payload())    # swapped, then served
    assert buffers.active_step == 2
    doc = metrics.summary()
    assert doc["staleness"] == {"mean": 0.5, "max": 1, "samples": 2}
    assert doc["swaps"]["steps"] == [2]
    assert serving.validate_metrics(doc) == []


def test_train_serve_cli_smoke_on_the_cpu(tmp_path):
    from repro_torch.serving.__main__ import main

    out = str(tmp_path / "serve_metrics.json")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["--device", "cpu", "--preset", "table2_quick", "--quick",
                   "--rounds", "2", "--qps", "30", "--settle-s", "10",
                   "--publish-dir", str(tmp_path / "pub"), "--out", out])
    assert rc == 0, buf.getvalue()
    doc = serving.load_metrics(out)
    assert jmetrics.load_metrics(out) == doc
    assert doc["requests"]["errors"] == 0
    assert doc["requests"]["served"] > 0
    assert doc["swaps"]["count"] >= 1
    assert doc["swaps"]["steps"][-1] == 2          # settled on the last step
    assert np.isfinite(doc["latency_us"]["p99"])
    assert "active_step=2" in buf.getvalue()
    assert sorted(os.listdir(tmp_path / "pub")) == [
        "step_00000001.json", "step_00000001.npz",
        "step_00000002.json", "step_00000002.npz"]


def test_train_serve_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.serving.__main__ import main

    assert main(["--rounds", "1"]) == 1


@pytest.mark.gpu
def test_watcher_stages_on_its_own_stream_bit_equal_on_the_card(tmp_path):
    """On the card: the watcher's side-stream staging gives the logits of a
    cold restore, bit for bit, while the default stream is busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging stream is CUDA's")
    dev = torch.device("cuda")
    d = str(tmp_path)
    p1 = {n: t.to(dev) for n, t in _mlp_params(1).items()}
    checkpoint.publish(d, 1, _mlp_params(2))
    buffers = serving.WeightBuffers(p1, step=0)
    watcher = serving.CheckpointWatcher(d, p1, buffers)
    server = serving.InferenceServer(serving.ClassifierAdapter(MLP, 4),
                                     watcher=watcher)
    busy = torch.randn(4096, 4096, device=dev)
    for _ in range(8):
        busy = busy @ busy / 4096.0         # queued on the default stream
    assert watcher.poll_once() == 1
    got = _served_logits(server, _payload())
    cold = serving.InferenceServer(serving.ClassifierAdapter(MLP, 4),
                                   checkpoint.restore(d, 1, like=p1))
    assert got.tobytes() == _served_logits(cold, _payload()).tobytes()
