"""Port: the federated LM step's participants on their own devices
(``launch/mesh.py``'s device arrays and ``participant_device``,
``launch/train.py``'s replicas, per-participant residual rows and the
gradient stage's order, ``launch/fl_train.py --devices``).

Without a card there is one device with data (the CPU), and ``meta``:

* an explicit all-``cpu`` device array gives v1 and v2 steps bit-equal to
  the single-device step (whose parity with the JAX reference
  ``tests/test_torch_fl_train.py`` holds), and so do per-participant
  residual rows on it;
* a mesh whose pod 1 is on ``meta`` shows that participant 1's replica,
  gradients, masks and encode inputs are made there, and that its
  gradients are started before participant 0's are handed out; the full
  step needs a second device with data (``chip_smoke.py``'s ``[fl_train]``
  (d) runs it with pod 0 on the card and pod 1 on the CPU);
* a checkpoint of per-participant rows is the reference's on-disk layout
  (``repro.checkpoint.store.restore`` reads it) and restores bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import checkpoint, configs, convert  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.types import SecureAggConfig, THGSConfig  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
AXES = ("pod", "data", "model")
THGS = THGSConfig(s0=0.1, alpha=0.9, s_min=0.01)   # test_torch_fl_train's
SA = SecureAggConfig(mask_ratio=0.05)
LR, B, T = 0.05, 8, 32
CPU, META = torch.device("cpu"), torch.device("meta")


def _cfg():
    return dataclasses.replace(configs.reduced(configs.get("yi_6b")),
                               dtype="float32")


def _model(seed: int = 0):
    return tf.init_params(_cfg(), torch.Generator().manual_seed(seed),
                          device="cpu")


def _batch(seed: int = 3) -> dict:
    rs = np.random.RandomState(seed)
    return {k: torch.from_numpy(rs.randint(0, _cfg().vocab, (B, T))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def _make_step(version: str):
    return (ttrain.make_fl_train_step if version == "v1"
            else ttrain.make_fl_train_step_v2)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


# ------------------------------------------------------------ the mesh
@pytest.mark.parametrize("shape,devices,want", [
    ((2, 2, 2), "cpu", [CPU] * 8),
    ((2, 2, 2), np.full((2, 2, 2), CPU, dtype=object), [CPU] * 8),
    ((2, 2, 2), [[["cpu", "cpu"], ["cpu", "cpu"]],
                 [["meta", "meta"], ["meta", "meta"]]], [CPU] * 4 + [META] * 4),
    ((2, 2, 2), ["cpu", "meta"], [CPU] * 4 + [META] * 4),
    ((2, 1, 2), ["cpu", "meta", "meta", "cpu"], [CPU, META, META, CPU]),
    ((4, 1), (CPU, META, CPU, META), [CPU, META, CPU, META]),
], ids=["one", "array", "nested", "one-a-pod", "one-a-position", "2d"])
def test_logical_mesh_takes_a_device_array(shape, devices, want):
    m = tmesh.LogicalMesh(shape, AXES[-len(shape):] if len(shape) < 3
                          else AXES, devices)
    assert m.devices.shape == shape and m.size == int(np.prod(shape))
    assert m.shape == dict(zip(m.axis_names, shape))
    assert list(m.devices.reshape(-1)) == want
    assert all(isinstance(d, torch.device) for d in m.devices.reshape(-1))


def test_debug_and_production_meshes_take_devices():
    d = tmesh.make_debug_mesh(2, 2, multi_pod=True, devices=["cpu", "meta"])
    assert d.shape == {"pod": 2, "data": 2, "model": 2}
    assert [tmesh.participant_device(d, "pod", p) for p in (0, 1)] == [
        CPU, META]
    per_pos = ["cpu"] * 4 + ["meta"] * 4
    assert (tmesh.make_debug_mesh(multi_pod=True, devices=per_pos).devices
            == d.devices).all()
    assert set(tmesh.make_debug_mesh(4, 1, devices=["meta"]).devices
               .reshape(-1)) == {META}
    p = tmesh.make_production_mesh(multi_pod=True, devices=["meta", "cpu"])
    assert p.shape == {"pod": 2, "data": 16, "model": 16} and p.size == 512
    assert (p.devices[0] == META).all() and (p.devices[1] == CPU).all()
    assert set(tmesh.make_production_mesh(devices=["cpu"]).devices
               .reshape(-1)) == {CPU}
    # no devices: every position on ``device``, as before
    assert set(tmesh.make_debug_mesh(multi_pod=True, device="meta").devices
               .reshape(-1)) == {META}
    with pytest.raises(ValueError, match="do not fit"):
        tmesh.make_debug_mesh(multi_pod=True, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="do not fit"):
        tmesh.LogicalMesh((2, 2), ("data", "model"), ["cpu"] * 3)


def test_participant_spanning_two_devices_raises():
    spread = [[["cpu", "meta"]], [["meta", "meta"]]]          # (2, 1, 2)
    mesh = tmesh.LogicalMesh((2, 1, 2), AXES, spread)
    assert tmesh.participant_device(mesh, "pod", 1) == META
    with pytest.raises(NotImplementedError, match="participant 0"):
        tmesh.participant_device(mesh, "pod", 0)
    # participant 0 runs tensor-parallel over its model positions; the
    # other participant takes the same grid layout on its one device
    for version in ("v1", "v2"):
        step = _make_step(version)(_cfg(), mesh, "pod", THGS, SA, lr=LR)
        assert step.groups == [[((CPU, META), range(0, 1))],
                               [((META, META), range(0, 1))]]
        assert step.devices == [CPU, META] and not step.f32
    with pytest.raises(ValueError, match="shard the parameters"):
        ttrain.init_fl_residuals(tf.init_params(_cfg(), device="meta"), 2,
                                 mesh)


def test_init_fl_residuals_places_rows():
    model = _model()
    leaves = convert.reference_leaves(model)
    mixed = tmesh.make_debug_mesh(multi_pod=True, devices=["cpu", "meta"])
    rows = ttrain.init_fl_residuals(model, 2, mixed)
    assert len(rows) == len(leaves)
    for r, lf in zip(rows, leaves):
        assert [x.device for x in r] == [CPU, META]
        assert all(x.shape == lf.shape and x.dtype == torch.bfloat16
                   for x in r)
        assert not r[0].any()
    one = tmesh.make_debug_mesh(multi_pod=True, devices=["cpu", "cpu"])
    for r, lf, today in zip(ttrain.init_fl_residuals(model, 2, one), leaves,
                            ttrain.init_fl_residuals(model, 2)):
        assert torch.is_tensor(r) and r.shape == (2,) + lf.shape
        assert r.device == CPU and r.dtype == torch.bfloat16
        assert today.shape == r.shape and today.device == r.device
    with pytest.raises(ValueError, match="3 participants"):
        ttrain.init_fl_residuals(model, 3, one)


# ------------------------------------------- steps bit-equal on the CPU
def _run(version: str, mesh, rows: bool, steps: int = 2):
    model = _model()
    step = _make_step(version)(_cfg(), mesh, "pod", THGS, SA, lr=LR)
    res = ttrain.init_fl_residuals(model, 2)
    if rows:    # a mesh of several devices' layout, on one device
        res = [list(r.clone()) for r in res]
    batch = _batch()
    losses = [step(model, res, batch, threefry.key(i))[2]
              for i in range(steps)]
    return model, ttrain.stacked_residuals(res), losses


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2)])
def test_all_cpu_device_array_step_is_bit_equal_to_the_one_device_step(
        version, shape):
    today = _run(version, tmesh.LogicalMesh(shape, AXES, "cpu"), False)
    arr = np.full(shape, CPU, dtype=object)
    for rows in (False, True):
        got = _run(version, tmesh.LogicalMesh(shape, AXES, arr), rows)
        for a, b in zip(today[0].parameters(), got[0].parameters()):
            assert (_bits(a) == _bits(b)).all()
        for a, b in zip(today[1], got[1]):
            assert (_bits(a) == _bits(b)).all()
        assert [_bits(x).tolist() for x in today[2]] == \
            [_bits(x).tolist() for x in got[2]]
    assert any(r.any() for r in today[1])


def test_residual_rows_on_the_wrong_device_raise():
    model = _model()
    mesh = tmesh.make_debug_mesh(multi_pod=True, devices=["cpu", "meta"])
    step = ttrain.make_fl_train_step(_cfg(), mesh, "pod", THGS, SA, lr=LR)
    res = ttrain.init_fl_residuals(model, 2)      # both rows on the CPU
    g = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    leaves, specs, sizes, leaf_k = step.layout(model)
    unit = step.units(leaves, specs, sizes, leaf_k)[0]
    with pytest.raises(ValueError, match="participant 1's residuals"):
        step.encode_unit(unit, leaves[unit[0]], g, res, 1, threefry.key(0))


# ------------------------------------------ a participant on ``meta``
def test_meta_participant_makes_gradients_and_stream_on_its_device(
        monkeypatch):
    model = _model()
    mesh = tmesh.make_debug_mesh(multi_pod=True, devices=["cpu", "meta"])
    step = ttrain.make_fl_train_step(_cfg(), mesh, "pod", THGS, SA, lr=LR)
    assert step.devices == [CPU, META]
    calls = []
    real = ttrain.step_gradients

    def counted(params, *a, **kw):
        calls.append(next(params.parameters()).device)
        return real(params, *a, **kw)

    monkeypatch.setattr(ttrain, "step_gradients", counted)
    it = step.gradients(model, _batch())
    loss0, g0 = next(it)
    # participant 1 (another device) was started before 0 was handed out
    assert calls == [CPU, META]
    loss1, g1 = next(it)
    assert calls == [CPU, META]
    assert loss0.device == CPU and loss1.device == META
    assert {t.device for t in g0.values()} == {CPU}
    assert {t.device for t in g1.values()} == {META}
    rep = step.replicas[META][1]
    assert rep is not model and step.replica(model, CPU) is model
    assert step.replica(model, META) is rep        # kept across steps
    assert [tuple(p.shape) for p in rep.parameters()] == [
        tuple(p.shape) for p in model.parameters()]

    # the encode: participant 1's inputs and masks on meta (the blocked
    # encode itself needs values: the meta stand-in returns no stream),
    # participant 0's stream on the CPU
    seen = []
    real_encode = ttrain.encode_leaf_blocked

    def spy(g, r, *a, **kw):
        seen.append((g.device, r.device, kw["masks"][0].device))
        if g.device == META:
            return None, r
        return real_encode(g, r, *a, **kw)

    monkeypatch.setattr(ttrain, "encode_leaf_blocked", spy)
    res = ttrain.init_fl_residuals(model, 2, mesh)
    leaves, specs, sizes, leaf_k = step.layout(model)
    units = step.units(leaves, specs, sizes, leaf_k)
    sts = [step.encode_unit(u, leaves[u[0]], g0, res, 0, threefry.key(0))
           for u in units]
    for u in units:
        step.encode_unit(u, leaves[u[0]], g1, res, 1, threefry.key(0))
    assert seen == [(CPU, CPU, CPU)] * len(units) + \
        [(META, META, META)] * len(units)
    assert {st.indices.device for st in sts} == {CPU}

    # v2 makes its gradients on the participants' devices too
    v2 = ttrain.make_fl_train_step_v2(_cfg(), mesh, "pod", THGS, SA, lr=LR)
    assert [{t.device for t in g.values()}
            for _, g in v2.gradients(model, _batch())] == [{CPU}, {META}]


def test_one_device_gradient_stage_makes_one_at_a_time(monkeypatch):
    model = _model()
    step = ttrain.make_fl_train_step(
        _cfg(), tmesh.make_debug_mesh(multi_pod=True, device="cpu"), "pod",
        THGS, SA, lr=LR)
    calls = []
    real = ttrain.step_gradients

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ttrain, "step_gradients", counted)
    it = step.gradients(model, _batch())
    next(it)
    assert len(calls) == 1 and not step.replicas
    next(it)
    assert len(calls) == 2


# ------------------------------------------------------- checkpoints
def test_checkpoint_of_rows_restores_bit_equal_in_reference_layout(tmp_path):
    model = _model()
    leaves = convert.reference_leaves(model)
    gen = torch.Generator().manual_seed(7)
    rows = [[(torch.randn(lf.shape, generator=gen) * 1e-2)
             .to(torch.bfloat16) for _ in range(2)] for lf in leaves]
    checkpoint.save(str(tmp_path), 5, fl_train.fl_state(model, rows))

    # the reference's own restore reads it: residuals [2, *leaf] in bf16
    jcfg = jconfigs.reduced(jconfigs.get("yi_6b"))
    pshapes = jax.eval_shape(lambda: jtf.init_params(
        dataclasses.replace(jcfg, dtype="float32"), jax.random.key(0)))
    like = {"params": pshapes, "residuals": jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((2,) + x.shape, jnp.bfloat16),
        pshapes)}
    ref = jstore.restore(str(tmp_path), 5, like)
    ref_res = jax.tree_util.tree_leaves(ref["residuals"])
    for r, want in zip(rows, ref_res):
        got = np.asarray(want.astype(jnp.float32))
        assert (torch.stack(r).float().numpy() == got).all()

    # restored onto fresh rows (and onto the stacked layout) bit for bit
    fresh = [[torch.zeros_like(x) for x in r] for r in rows]
    model2 = _model(seed=1)
    fl_train.load_fl_state(model2, fresh, checkpoint.restore(
        str(tmp_path), 5, like=fl_train.fl_state(model2, fresh)))
    stacked = ttrain.init_fl_residuals(model2, 2)
    ttrain.load_residuals(stacked, ttrain.stacked_residuals(rows))
    for r, f, s in zip(rows, fresh, stacked):
        for p in range(2):
            assert (_bits(r[p]) == _bits(f[p])).all()
            assert (_bits(r[p]) == _bits(s[p])).all()
    for a, b in zip(model.parameters(), model2.parameters()):
        assert (_bits(a) == _bits(b)).all()


# --------------------------------------------------------------- the CLI
def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--log-every",
         "1", *args], capture_output=True, text=True, env=ENV, cwd=cwd,
        timeout=600)


def test_cli_devices_runs_two_steps_as_one_device(tmp_path):
    two = _cli("--devices", "cpu,cpu", "--steps", "2", "--ckpt",
               str(tmp_path / "a"), cwd=tmp_path)
    one = _cli("--device", "cpu", "--steps", "2", "--ckpt",
               str(tmp_path / "b"), cwd=tmp_path)
    assert two.returncode == 0 and one.returncode == 0, two.stderr
    losses = [ln for ln in two.stdout.splitlines() if "loss=" in ln]
    assert len(losses) == 2
    assert losses == [ln for ln in one.stdout.splitlines() if "loss=" in ln]
    with np.load(tmp_path / "a" / "step_00000002.npz") as a, \
            np.load(tmp_path / "b" / "step_00000002.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_refuses_an_absent_card(tmp_path):
    p = _cli("--devices", "cpu,cuda:7", "--steps", "1", "--ckpt",
             str(tmp_path / "c"), cwd=tmp_path)
    assert p.returncode == 1 and "cuda:7" in p.stderr, p.stderr
    assert not (tmp_path / "c").exists()
