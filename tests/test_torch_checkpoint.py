"""Port parity: the checkpoint store and checkpoint/resume (slice F).

* Store: round trips (a bf16 leaf, int-keyed residuals, a string-keyed
  ring), ``latest_step``, a crash mid-dump, the shape and missing-leaf
  errors.
* Across the packages, both ways, bit for bit: a checkpoint the JAX package
  writes restores in the port and the other way round, over mnist_mlp's
  params, residuals keyed by client id and a ring; both packages write the
  same leaf keys and the same manifest.
* Engine: a run killed after round 1 and resumed under the same horizon
  replays the uninterrupted run bit for bit (sync, async, DP); an orphaned
  npz and a truncated sidecar fall back to the older pair; the port resumes
  a directory the reference wrote, its remaining rounds giving the
  reference's slot facts and losses within rtol 1e-4 (local SGD in f32
  sums in another order, as in ``tests/test_torch_tree_async.py``).
* The ledger's resume and costing methods against the reference's; the CLI
  flags; the new modules import nothing of JAX or of ``repro``.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core.types import SecureAggConfig as JSA  # noqa: E402
from repro.core.types import THGSConfig as JTHGS  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.sim import SimConfig as JSimConfig  # noqa: E402
from repro.sim.engine import Simulation as JSim  # noqa: E402
from repro.sim.ledger import CommLedger as JLedger  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core.dp import DPConfig  # noqa: E402
from repro_torch.core.types import SecureAggConfig, THGSConfig  # noqa: E402
from repro_torch.sim import (AsyncSimulation, CommLedger,  # noqa: E402
                             SimConfig, Simulation, presets)
from repro_torch.sim.__main__ import main as sim_main  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "1"}

# the reference's tests/test_sim.py::_TINY, in the port's types
_TINY = SimConfig(
    name="tiny", partition="noniid", noniid_k=4, n_clients=5,
    clients_per_round=3, rounds=4, n_train=300, n_test=120,
    local_steps=2, local_batch=8, eval_every=1,
    thgs=THGSConfig(s0=0.1, alpha=0.9, s_min=0.02),
    sa=SecureAggConfig(mask_ratio=0.02), dropout_rate=0.25, seed=3)
_JTINY = JSimConfig(
    name="tiny", partition="noniid", noniid_k=4, n_clients=5,
    clients_per_round=3, rounds=4, n_train=300, n_test=120,
    local_steps=2, local_batch=8, eval_every=1,
    thgs=JTHGS(s0=0.1, alpha=0.9, s_min=0.02),
    sa=JSA(mask_ratio=0.02), dropout_rate=0.25, seed=3)
_ASYNC = presets.get("async_quick").replace(
    rounds=4, n_train=300, n_test=100, eval_every=1, out_json=None)
_DP = _TINY.replace(name="dp_tiny",
                    dp=DPConfig(clip=1.0, sigma=0.6, delta=1e-5))


def _bits(t) -> np.ndarray:
    """The raw bits of a tensor or array (bf16 as int16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(np.int32 if t.element_size() == 4 else np.int8)
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _port_tree(seed: int) -> dict:
    """A checkpoint-shaped tree: params, int-keyed residuals, a ring, and
    a bf16 leaf."""
    g = torch.Generator().manual_seed(seed)

    def params():
        return {"l0.b": torch.randn(5, generator=g),
                "l0.w": torch.randn(3, 5, generator=g),
                "l1.w": torch.randn(5, 2, generator=g)}

    return {"params": params(),
            "residuals": {0: params(), 3: params()},
            "ring": {"0": params(), "1": params()},
            "half": {"h": torch.randn(4, 3, generator=g).bfloat16()}}


def _like(tree):
    return tckpt.map_leaves(torch.zeros_like, tree)


def _flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flat_leaves(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def _assert_trees_bit_equal(a, b):
    la, lb = _flat_leaves(a), _flat_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, k
        assert np.array_equal(_bits(x), _bits(y)), k


# ---------------------------------------------------------------- the store
def test_store_round_trip_bf16_int_and_string_keys(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    tree = _port_tree(0)
    path = tckpt.save(d, 7, tree)
    assert path.endswith("step_00000007.npz")
    back = tckpt.restore(d, 7, like=_like(tree))
    _assert_trees_bit_equal(back, tree)
    assert back["half"]["h"].dtype == torch.bfloat16
    manifest = json.loads((tmp_path / "ck" / "step_00000007.json").read_text())
    assert manifest["step"] == 7
    assert manifest["leaves"]["['half']::['h']"] == {"shape": [4, 3],
                                                     "dtype": "float32"}
    assert manifest["leaves"]["['residuals']::[3]::['l0']::['w']"] == {
        "shape": [3, 5], "dtype": "float32"}
    assert "['ring']::['1']::['l1']::['w']" in manifest["leaves"]
    tckpt.save(d, 12, tree)
    assert tckpt.latest_step(d) == 12
    assert sorted(os.listdir(d)) == ["step_00000007.json",
                                     "step_00000007.npz",
                                     "step_00000012.json",
                                     "step_00000012.npz"]


def test_crash_mid_dump_keeps_the_last_good_pair(tmp_path):
    d = str(tmp_path)
    t1, t2 = _port_tree(1), _port_tree(2)
    tckpt.publish(d, 1, t1)
    tckpt.publish(d, 2, t2)
    # crash A: manifest truncated by a writer that bypassed tmp + replace
    with open(os.path.join(d, "step_00000002.json"), "w") as f:
        f.write('{"step": 2, "lea')
    # crash B: an npz without a manifest; crash C: a stray tmp npz
    shutil.copy(os.path.join(d, "step_00000002.npz"),
                os.path.join(d, "step_00000003.npz"))
    shutil.copy(os.path.join(d, "step_00000002.npz"),
                os.path.join(d, "step_00000004.npz.tmp.npz"))
    assert tckpt.latest_published_step(d) == 1
    assert tckpt.latest_published_step(d, after=1) is None
    _assert_trees_bit_equal(tckpt.restore(d, 1, like=_like(t1)), t1)
    tckpt.publish(d, 2, t2)              # the publisher retries
    assert tckpt.latest_published_step(d) == 2
    assert tckpt.latest_published_step(d, after=1) == 2


def test_restore_rejects_shape_mismatch_and_missing_leaf(tmp_path):
    d = str(tmp_path)
    tree = _port_tree(3)
    tckpt.save(d, 1, tree)
    bad = _like(tree)
    bad["params"]["l0.w"] = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(d, 1, like=bad)
    extra = _like(tree)
    extra["params"]["l2.w"] = torch.zeros(2)
    with pytest.raises(KeyError, match="l2"):
        tckpt.restore(d, 1, like=extra)


def test_read_host_gives_host_tensors_of_like_dtypes(tmp_path):
    d = str(tmp_path)
    tree = _port_tree(4)
    tckpt.save(d, 1, tree)
    host = tckpt.read_host(d, 1, _like(tree))
    _assert_trees_bit_equal(host, tree)
    assert all(t.device.type == "cpu" for _, t in _flat_leaves(host))


# ------------------------------------------------------- across the packages
def _jax_tree(seed: int) -> dict:
    """The reference's layout of the same kind of tree over mnist_mlp."""
    model = jpm.PAPER_MODELS["mnist_mlp"]
    p0 = model.init(jax.random.key(seed))
    rs = np.random.RandomState(seed)

    def noise_like(p):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(rs.randn(*x.shape).astype(np.float32)), p)

    return {"params": p0,
            "residuals": {0: noise_like(p0), 4: noise_like(p0)},
            "ring": {"0": p0, "1": noise_like(p0), "2": noise_like(p0)},
            "half": {"h": jnp.asarray(rs.randn(6, 7), jnp.bfloat16)}}


def _port_of(jtree) -> dict:
    """The port's layout of a reference tree: flat ``outer.inner`` params."""
    def flat(p):
        return {f"{o}.{i}": torch.from_numpy(np.array(v))
                for o, inner in p.items() for i, v in inner.items()}

    return {"params": flat(jtree["params"]),
            "residuals": {c: flat(r) for c, r in jtree["residuals"].items()},
            "ring": {k: flat(r) for k, r in jtree["ring"].items()},
            "half": {"h": torch.from_numpy(
                np.array(jtree["half"]["h"]).view(np.int16)
            ).view(torch.bfloat16)}}


def test_reference_checkpoint_restores_in_the_port_bit_exact(tmp_path):
    jtree = _jax_tree(0)
    want = _port_of(jtree)
    jckpt.save(str(tmp_path), 5, jtree)
    got = tckpt.restore(str(tmp_path), 5, like=_like(want))
    _assert_trees_bit_equal(got, want)
    assert set(got["residuals"]) == {0, 4}
    assert set(got["ring"]) == {"0", "1", "2"}


def test_port_checkpoint_restores_in_the_reference_bit_exact(tmp_path):
    jtree = _jax_tree(1)
    tckpt.save(str(tmp_path / "t"), 5, _port_of(jtree))
    got = jckpt.restore(str(tmp_path / "t"), 5, like=jtree)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat_got) == len(flat_want)
    for (pg, g), (pw, w) in zip(flat_got, flat_want):
        assert pg == pw and g.dtype == w.dtype
        assert np.array_equal(_bits(g), _bits(w)), pg
    # both packages write the same leaves, in the same order, under the
    # same manifest
    jckpt.save(str(tmp_path / "j"), 5, jtree)
    for name in ("t", "j"):
        assert (tmp_path / name / "step_00000005.json").exists()
    assert json.loads((tmp_path / "t" / "step_00000005.json").read_text()) \
        == json.loads((tmp_path / "j" / "step_00000005.json").read_text())
    with np.load(tmp_path / "t" / "step_00000005.npz") as t, \
            np.load(tmp_path / "j" / "step_00000005.npz") as j:
        assert list(t.keys()) == list(j.keys())
        for k in j.keys():
            assert t[k].dtype == j[k].dtype
            assert np.array_equal(t[k].view(np.int32), j[k].view(np.int32))


# ------------------------------------------------------------------- engine
class _Killed(Exception):
    pass


def _die_after_round_1(r, info):
    if r == 1:
        raise _Killed


def _state_bits_equal(a, b) -> bool:
    return (all(np.array_equal(_bits(a.params[n]), _bits(b.params[n]))
                for n in a.params)
            and sorted(a.residuals) == sorted(b.residuals)
            and all(np.array_equal(_bits(a.residuals[c][n]),
                                   _bits(b.residuals[c][n]))
                    for c in a.residuals for n in a.params)
            and a.losses == b.losses and a.round == b.round)


@pytest.mark.parametrize("cfg", [_TINY, _ASYNC, _DP],
                         ids=["sync", "async", "dp"])
def test_killed_and_resumed_run_is_bit_identical(tmp_path, cfg):
    ck = str(tmp_path / "ck")
    ckcfg = cfg.replace(ckpt_dir=ck, ckpt_every=1)
    Sim = AsyncSimulation if cfg.mode == "async" else Simulation
    with pytest.raises(_Killed):
        Sim(ckcfg, device="cpu").run(hooks=[_die_after_round_1])
    seen = []
    resumed_sim = Sim(ckcfg, device="cpu")
    resumed = resumed_sim.run(hooks=[lambda r, info: seen.append(r)])
    full_sim = Sim(cfg, device="cpu")
    full = full_sim.run()
    assert seen == list(range(2, cfg.rounds))      # resumed from round 2
    assert resumed.ledger.entries == full.ledger.entries
    assert resumed.accuracies == full.accuracies
    assert resumed.losses == full.losses
    assert _state_bits_equal(resumed_sim.state, full_sim.state)
    if cfg.mode == "async":
        assert len(resumed_sim.versions) == len(full_sim.versions)
        for v_r, v_f in zip(resumed_sim.versions, full_sim.versions):
            assert all(np.array_equal(_bits(v_r[n]), _bits(v_f[n]))
                       for n in v_f)
        assert any(t > 0 for e in resumed.ledger.entries[2:]
                   for t in e.staleness)
    if cfg.dp is not None:
        assert resumed.ledger.privacy() == full.ledger.privacy()


def _two_round_run(tmp_path):
    ck = str(tmp_path / "ck")
    cfg = _TINY.replace(rounds=2, ckpt_dir=ck, ckpt_every=1)
    full_sim = Simulation(cfg, device="cpu")
    return ck, cfg, full_sim, full_sim.run()


def test_resume_skips_an_orphaned_npz(tmp_path):
    ck, cfg, full_sim, full = _two_round_run(tmp_path)
    # a crash between the step-2 npz and its sidecar
    os.remove(os.path.join(ck, "sim_00000002.json"))
    seen = []
    sim = Simulation(cfg, device="cpu")
    resumed = sim.run(hooks=[lambda r, info: seen.append(r)])
    assert seen == [1]                          # resumed from step 1
    assert resumed.ledger.entries == full.ledger.entries
    assert resumed.losses == full.losses
    assert _state_bits_equal(sim.state, full_sim.state)


def test_resume_falls_back_past_a_truncated_sidecar(tmp_path):
    ck, cfg, full_sim, full = _two_round_run(tmp_path)
    sidecar = os.path.join(ck, "sim_00000002.json")
    blob = open(sidecar).read()
    with open(sidecar, "w") as f:
        f.write(blob[: len(blob) // 2])
    sim = Simulation(cfg, device="cpu")
    with pytest.warns(RuntimeWarning, match="sidecar"):
        resumed = sim.run()                     # resumes from step 1
    assert resumed.ledger.entries == full.ledger.entries
    assert resumed.losses == full.losses
    assert _state_bits_equal(sim.state, full_sim.state)


def test_resume_refuses_a_checkpoint_past_the_horizon(tmp_path):
    ck, cfg, _, _ = _two_round_run(tmp_path)
    with pytest.raises(ValueError, match="horizon"):
        Simulation(cfg.replace(rounds=1), device="cpu").run()
    # resume=False ignores the directory
    res = Simulation(cfg.replace(rounds=1, ckpt_every=0),
                     device="cpu").run(resume=False)
    assert len(res.ledger) == 1


def _facts(ledger):
    return [(e.ks, e.k_masks, e.n_clients, e.n_survivors, e.threshold)
            for e in ledger.entries]


def test_port_resumes_a_directory_the_reference_wrote(tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(_Killed):
        JSim(_JTINY.replace(ckpt_dir=ck, ckpt_every=1)).run(
            hooks=[_die_after_round_1])
    jfull = JSim(_JTINY).run(resume=False)
    seen = []
    res = Simulation(_TINY.replace(ckpt_dir=ck, ckpt_every=1),
                     device="cpu").run(hooks=[lambda r, i: seen.append(r)])
    assert seen == [2, 3]
    assert _facts(res.ledger) == _facts(jfull.ledger)
    assert any(e.n_survivors < e.n_clients for e in res.ledger.entries[2:])
    np.testing.assert_allclose(res.losses, jfull.losses, rtol=1e-4)
    assert res.accuracies[:2] == jfull.accuracies[:2]
    # the port's own checkpoint of round 4 sits beside the reference's
    assert sorted(f for f in os.listdir(ck) if f.startswith("sim_")) == [
        "sim_00000001.json", "sim_00000002.json", "sim_00000003.json",
        "sim_00000004.json"]


# ------------------------------------------------------------------- ledger
def _records(costs_mod):
    recs = []
    for t, (surv, stale) in enumerate([(4, ()), (3, ()), (4, (0, 2, 1, 0))]):
        recs.append(costs_mod.round_record(
            t, model_size=1000, ks=[8, 3], k_masks=[2, 1], n_clients=4,
            n_survivors=surv, threshold=3, leaf_sizes=[900, 100],
            staleness=stale, dp_clip=1.0 if t else 0.0,
            dp_sigma=0.8 if t else 0.0, dp_delta=1e-5))
    return recs


def test_ledger_resume_and_costing_methods_match_reference():
    tled, jled = CommLedger(), JLedger()
    tled.extend(_records(tcosts))
    jled.extend(_records(jcosts))
    assert len(tled) == len(jled) == 3
    for acct in ("paper", "tpu"):
        assert tled.per_round(acct) == jled.per_round(acct)
        for n in range(4):
            assert (tled.upload_bits_through(n, acct)
                    == jled.upload_bits_through(n, acct))
    entries = json.loads(json.dumps(jled.summary()["entries"]))
    back = CommLedger.from_entry_dicts(entries)
    assert back.entries == tled.entries
    assert back.summary() == tled.summary() == jled.summary()
    assert CommLedger.from_entry_dicts(
        json.loads(json.dumps(tled.summary()["entries"]))).entries \
        == tled.entries


# ---------------------------------------------------------------------- CLI
def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    ck, a, b = (str(tmp_path / n) for n in ("ck", "a.json", "b.json"))
    args = ["--preset", "ci_smoke", "--device", "cpu", "--rounds", "2",
            "--seed", "5", "--dropout", "0.3", "--ckpt-dir", ck,
            "--ckpt-every", "1"]
    assert sim_main(args + ["--out", a]) == 0
    assert sorted(f for f in os.listdir(ck) if f.endswith(".npz")) == [
        "step_00000001.npz", "step_00000002.npz"]
    capsys.readouterr()
    assert sim_main(args + ["--out", b]) == 0          # resumes at round 2
    assert "round    1" not in capsys.readouterr().out
    da, db = (json.loads(Path(p).read_text()) for p in (a, b))
    assert da["ledger"] == db["ledger"] and da["losses"] == db["losses"]
    assert da["config"]["seed"] == 5
    assert da["config"]["dropout_rate"] == 0.3
    assert sim_main(args + ["--no-resume", "--rounds", "1",
                            "--out", b]) == 0
    assert len(json.loads(Path(b).read_text())["losses"]) == 1


def test_checkpoint_and_serving_modules_import_no_jax():
    code = ("import sys, repro_torch.checkpoint, repro_torch.sim.engine, "
            "repro_torch.sim.__main__, repro_torch.serving.hot_swap, "
            "repro_torch.serving.__main__; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
