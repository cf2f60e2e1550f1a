"""Port: one participant spread over its ``data`` positions
(``launch/mesh.py::participant_groups``, ``launch/fsdp.py``, the sharded
paths of ``launch/train.py``, ``launch/fl_train.py`` and the checkpoint).

Without a card there is one device with data (the CPU), and ``meta``:

* placement on ``[cpu, meta]`` groups gives chunks of the reference's
  ``param_specs`` shard shapes (a group's chunk: its positions' shards,
  concatenated), on mesh (2, 2, 1) and the production (2, 16, 16);
* two explicit groups on the CPU are bit-equal to the one-device step with
  twice the microbatches: the dense step for all ten families, the v1 and
  v2 FL steps (params, residuals, loss, streams);
* the training forward saves no gathered weight outside the checkpoints;
* a sharded checkpoint is the reference's on-disk layout
  (``repro.checkpoint.store.restore`` reads it) and resumes bit for bit;
* ``fl_train --devices cpu,cpu,cpu,cpu`` is ``--device cpu``.

The sharded FL steps against the reference's real (2, 2, 1) run are in
``tests/test_torch_fl_train.py``.
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
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import checkpoint, configs, convert  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.types import SecureAggConfig, THGSConfig  # noqa: E402
from repro_torch.launch import fl_train, fsdp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
AXES = ("pod", "data", "model")
THGS = THGSConfig(s0=0.1, alpha=0.9, s_min=0.01)   # test_torch_fl_train's
SA = SecureAggConfig(mask_ratio=0.05)
LR = 0.05
CPU, META = torch.device("cpu"), torch.device("meta")
TWO = [(CPU, range(0, 1)), (CPU, range(1, 2))]     # two groups, one device


def _cfg(arch: str = "yi_6b", dtype: str = "float32"):
    return dataclasses.replace(configs.reduced(configs.get(arch)),
                               dtype=dtype)


def _model(cfg, seed: int = 0):
    return tf.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def _batch(cfg, B: int, T: int, seed: int = 3) -> dict:
    rs = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    dtype = tf.DTYPES[cfg.dtype]
    batch = {"labels": torch.from_numpy(
        rs.randint(0, cfg.vocab, (B, T)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, T, cfg.d_model),
                                      generator=gen).to(dtype)
    else:
        batch["tokens"] = torch.from_numpy(
            rs.randint(0, cfg.vocab, (B, T)).astype(np.int32))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (B, cfg.n_image_tokens, cfg.d_model), generator=gen).to(dtype)
    return batch


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((_bits(a) == _bits(b)).all())


def _same_model(model, sharded) -> list:
    """Names whose values differ between a model and sharded params."""
    return [n for n, p in model.named_parameters()
            if not _same(p, sharded.full(n))]


# ------------------------------------------------------------ the groups
@pytest.mark.parametrize("shape,devices,fed,want", [
    ((2, 2, 1), "cpu", "pod", [(CPU, range(0, 2))]),
    ((2, 2, 1), [["cpu", "meta"], ["cpu", "cpu"]], "pod",
     [(CPU, range(0, 1)), (META, range(1, 2))]),
    ((2, 4, 2), [["cpu", "cpu", "meta", "meta"]] * 2, "pod",
     [(CPU, range(0, 2)), (META, range(2, 4))]),
    ((3, 1), ["meta", "cpu", "cpu"], None,
     [(META, range(0, 1)), (CPU, range(1, 3))]),
    ((2, 1, 2), "cpu", "pod", [(CPU, range(0, 1))]),
], ids=["one", "two", "runs", "dense", "one-position"])
def test_participant_groups(shape, devices, fed, want):
    axes = AXES if len(shape) == 3 else AXES[1:]
    mesh = tmesh.LogicalMesh(shape, axes, devices)
    assert tmesh.participant_groups(mesh, fed, 0) == want


def test_participant_groups_refuse_interleaving_and_model_spreads():
    inter = tmesh.LogicalMesh((3, 1), AXES[1:], ["cpu", "meta", "cpu"])
    with pytest.raises(ValueError, match="contiguous"):
        tmesh.participant_groups(inter, None)
    spread = tmesh.LogicalMesh((2, 1, 2), AXES, [[["cpu", "meta"]],
                                                 [["cpu", "cpu"]]])
    assert tmesh.participant_groups(spread, "pod", 1) == [(CPU, range(0, 1))]
    # a spread along model is the participant's (data group, model
    # position) grid: one device a model position (tensor parallelism)
    assert tmesh.participant_groups(spread, "pod", 0) == [((CPU, META),
                                                          range(0, 1))]
    grid = tmesh.LogicalMesh((1, 3, 2), AXES, [[["cpu", "meta"]] * 2
                                               + [["meta", "meta"]]])
    assert tmesh.participant_groups(grid, "pod", 0) == [
        ((CPU, META), range(0, 2)), ((META, META), range(2, 3))]
    inter2 = tmesh.LogicalMesh((3, 2), AXES[1:], [["cpu", "meta"],
                                                  ["meta", "meta"],
                                                  ["cpu", "meta"]])
    with pytest.raises(ValueError, match="contiguous"):
        tmesh.participant_groups(inter2, None)
    with pytest.raises(ValueError, match="cover"):
        fsdp.check_groups([(CPU, range(0, 1))], 2)
    with pytest.raises(ValueError, match="contiguous"):
        fsdp.check_groups([(CPU, range(1, 2)), (CPU, range(0, 1))], 2)


# -------------------------------------------------------------- placement
@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b", "zamba2_7b",
                                  "xlstm_125m"])
@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 16, 16)])
def test_placement_chunks_are_the_reference_shards(arch, shape):
    n_data = shape[1]
    half = n_data // 2
    devs = np.empty(shape, dtype=object)
    devs[:, :half], devs[:, half:] = CPU, META
    mesh = tmesh.LogicalMesh(shape, AXES, devs)
    cfg = _cfg(arch)
    lm = fsdp.empty(cfg, mesh, "pod")
    assert lm.groups == [(CPU, range(0, half)), (META, range(half, n_data))]
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    pshapes = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
    fake = type("M", (), {"axis_names": AXES,
                          "devices": np.empty(shape, dtype=object)})()
    specs = jshd.param_specs(pshapes, jmesh.logical_rules(fake,
                                                          fed_axis="pod"),
                             fake)
    flat = {".".join(k.key for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    one = AbstractMesh((2, n_data, 1), AXES)     # the data shards alone
    n_split = 0
    for lf in convert.reference_leaves(lm.meta):
        shard = NamedSharding(one, flat[lf.path]).shard_shape(lf.shape)
        d = lm.dims[lf.names[0]]
        for g, (dev, pos) in enumerate(lm.groups):
            stacked = lf.lead + tuple(lm.chunks[g][lf.names[0]].shape)
            want = list(shard)
            if d is not None:
                want[d + len(lf.lead)] *= len(pos)
                n_split += 1
            assert stacked == tuple(want), lf.path
            assert all(lm.chunks[g][n].device == dev for n in lf.names)
    assert n_split > 0


def test_whole_leaves_have_one_copy_a_device():
    cfg = _cfg()
    mesh = tmesh.LogicalMesh((2, 4, 1), AXES, "meta")
    dims = fsdp.split_dims(tf.init_params(cfg, device="meta"), mesh, "pod")
    lm = fsdp.ShardedLM(cfg, [(CPU, range(0, 1)), (CPU, range(1, 2)),
                              (META, range(2, 4))], 4, dims)
    whole = [n for n, d in lm.dims.items() if d is None]
    assert whole and all(lm.chunks[0][n] is lm.chunks[1][n]
                         and lm.chunks[2][n].device == META for n in whole)
    assert len(list(lm.tensors())) == 2 * len(whole) + 3 * (
        len(lm.dims) - len(whole))
    with pytest.raises(ValueError, match="divide"):
        fsdp.ShardedLM(cfg, [(CPU, range(0, 3))], 3, dims)


def test_values_round_trip_and_refresh_across_groups():
    cfg = _cfg()
    model = _model(cfg)
    mesh = tmesh.LogicalMesh((2, 1), AXES[1:], "cpu")
    lm = fsdp.shard(model, mesh, groups=TWO)
    assert not _same_model(model, lm)
    tree = convert.lm_tree_to_numpy(lm, cfg)
    assert not _same_model(model, fsdp.shard_reference(tree, cfg, mesh,
                                                       groups=TWO))
    one = fsdp.ShardedLM(cfg, [(CPU, range(0, 2))], 2, lm.dims)
    one.refresh_from(lm)
    assert not _same_model(model, one)
    back = fsdp.ShardedLM(cfg, TWO, 2, lm.dims)
    back.refresh_from(one)
    assert not _same_model(model, back)
    with pytest.raises(ValueError, match="shape"):
        lm.load_("embed", torch.zeros(3))


# ------------------------------------------------ the dense step, bit-equal
@pytest.mark.parametrize("arch", configs.all_archs())
def test_two_group_dense_step_is_bit_equal_to_twice_the_microbatches(arch):
    cfg = _cfg(arch)
    batch = _batch(cfg, 4, 32)
    one = _model(cfg)
    _, want = ttrain.make_dense_train_step(cfg, 0.01, n_micro=2)(one, batch)
    mesh = tmesh.LogicalMesh((2, 1), AXES[1:], "cpu")
    lm = fsdp.shard(_model(cfg), mesh, groups=TWO)
    _, got = ttrain.make_dense_train_step(cfg, 0.01)(lm, batch)
    assert _same(got, want)
    assert not _same_model(one, lm)


def test_dense_step_microbatches_dtype_and_mesh_checks():
    cfg = _cfg("yi_6b", "bfloat16")
    batch = _batch(cfg, 4, 32)
    mesh = tmesh.LogicalMesh((2, 1), AXES[1:], "cpu")
    one = _model(cfg)
    loss_1, g_1 = ttrain.step_gradients(one, cfg, batch, 4)
    lm = fsdp.shard(_model(cfg), mesh, groups=TWO)
    loss_2, g_2 = fsdp.step_gradients(lm, cfg, batch, 2)
    assert _same(loss_1, loss_2)
    assert all(_same(g_1[n], g_2.full(n, CPU)) for n in g_1)
    assert {t.dtype for c in g_2.chunks for t in c.values()} == {
        torch.float32}
    # one group and one microbatch keep the parameters' dtype
    solo = fsdp.shard(_model(cfg), mesh, groups=[(CPU, range(0, 2))])
    loss_3, g_3 = fsdp.step_gradients(solo, cfg, batch)
    loss_4, g_4 = ttrain.value_and_grad(_model(cfg), cfg, batch)
    assert _same(loss_3, loss_4)
    assert all(_same(g_4[n], g_3.full(n, CPU)) for n in g_4)
    # a mesh: the parameters must be placed on its groups
    spread = tmesh.LogicalMesh((2, 1), AXES[1:], ["cpu", "meta"])
    with pytest.raises(ValueError, match="fsdp.shard"):
        ttrain.make_dense_train_step(cfg, mesh=spread)(_model(cfg), batch)
    with pytest.raises(ValueError, match="groups"):
        ttrain.make_dense_train_step(cfg, mesh=spread)(lm, batch)
    with pytest.raises(ValueError, match="split"):
        fsdp.step_gradients(lm, cfg, _batch(cfg, 3, 32))


def test_gathered_weights_are_not_saved_outside_the_checkpoints():
    cfg = _cfg()
    mesh = tmesh.LogicalMesh((2, 1), AXES[1:], "cpu")
    lm = fsdp.shard(_model(cfg), mesh, groups=TWO)
    split = {lm.shapes[n] for n, d in lm.dims.items() if d is not None}
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    leaves = [t for _, t in lm.tensors()]
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tf.train_loss(lm.view(0), cfg, _batch(cfg, 2, 32))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert loss.requires_grad
    assert not split & set(saved), sorted(split & set(saved))


# --------------------------------------------------- the FL steps, bit-equal
def _fl_run(version: str, sharded: bool, steps: int = 2, n_micro: int = 1):
    cfg = _cfg()
    mesh = tmesh.LogicalMesh((2, 2, 1), AXES, "cpu")
    mk = (ttrain.make_fl_train_step if version == "v1"
          else ttrain.make_fl_train_step_v2)
    model = _model(cfg)
    if sharded:
        groups = [TWO, TWO]
        model = fsdp.shard(model, mesh, "pod", groups=TWO)
        step = mk(cfg, mesh, "pod", THGS, SA, lr=LR, n_micro=n_micro,
                  groups=groups)
        res = ttrain.init_fl_residuals(model, 2, mesh, "pod", groups=groups)
    else:
        step = mk(cfg, mesh, "pod", THGS, SA, lr=LR, n_micro=n_micro)
        res = ttrain.init_fl_residuals(model, 2)
    batch = _batch(cfg, 8, 32)
    records, losses = [], []
    for i in range(steps):
        rec = []
        losses.append(step(model, res, batch, threefry.key(i),
                           record=rec)[2])
        records.append(rec)
    return model, res, losses, records


def _streams(records) -> list:
    out = []
    for rec in records:
        for r in rec:
            sts = r["streams"] if isinstance(r["streams"], list) \
                else [r["streams"]]
            out += [(st.indices, st.values) for st in sts]
    return out


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_two_group_fl_steps_are_bit_equal_to_twice_the_microbatches(
        version):
    want = _fl_run(version, False, n_micro=2)
    got = _fl_run(version, True)
    assert not _same_model(want[0], got[0])
    for a, b in zip(ttrain.stacked_residuals(want[1]),
                    ttrain.stacked_residuals(got[1])):
        assert _same(a, b)
    assert all(_same(a, b) for a, b in zip(want[2], got[2]))
    pairs = list(zip(_streams(want[3]), _streams(got[3])))
    assert pairs and all(_same(a[0], b[0]) and _same(a[1], b[1])
                         for a, b in pairs)
    assert any(r.any() for r in ttrain.stacked_residuals(got[1]))
    # the rows are chunks on the groups' devices
    rows = got[1]
    assert all(isinstance(r, fsdp.ChunkedRow) for row in rows for r in row)
    assert {len(r.parts) for row in rows for r in row} == {1, 2}


def test_sharded_step_refuses_unsharded_params_and_misplaced_rows():
    cfg = _cfg()
    mesh = tmesh.LogicalMesh((2, 2, 1), AXES, [["cpu", "meta"]] * 2)
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", THGS, SA, lr=LR)
    assert step.devices == [CPU, CPU] and step.f32
    with pytest.raises(ValueError, match="shard the parameters"):
        next(step.gradients(_model(cfg), _batch(cfg, 8, 32)))
    with pytest.raises(ValueError, match="shard the parameters"):
        ttrain.init_fl_residuals(_model(cfg), 2, mesh)
    lm = fsdp.shard(_model(cfg), mesh, "pod")
    rows = ttrain.init_fl_residuals(lm, 2, mesh)
    split = next(i for i, r in enumerate(rows) if r[0].dim is not None)
    assert [p.device for p in rows[split][1].parts] == [CPU, META]
    wrong = ttrain.init_fl_residuals(lm, 2, groups=[TWO, TWO])
    leaves, specs, sizes, leaf_k = step.layout(lm)
    unit = next(u for u in step.units(leaves, specs, sizes, leaf_k)
                if u[0] == split)
    g = {n: torch.zeros(s) for n, s in lm.shapes.items()}
    with pytest.raises(ValueError, match="participant 1's residuals"):
        step.encode_unit(unit, leaves[split], g, wrong, 1, threefry.key(0))


def test_chunked_row_slices_match_the_whole_row():
    gen = torch.Generator().manual_seed(1)
    full = torch.randn((4, 6, 8), generator=gen)
    row = fsdp.ChunkedRow([full[:, :2].clone(), full[:, 2:].clone()], 1)
    assert _same(row.cpu(), full) and row.shape == (4, 6, 8)
    for i in range(4):
        assert _same(row.slice_to(4, (6, 8), i, CPU), full[i])
    new = torch.randn((6, 8), generator=gen)
    row.put_slice(4, (6, 8), 2, new)
    full[2] = new
    assert _same(row.cpu(), full)
    with pytest.raises(ValueError, match="cuts"):
        row.slice_to(24, (8,), 0, CPU)


# ------------------------------------------------------------ checkpoints
def test_sharded_checkpoint_is_the_reference_layout_and_resumes(tmp_path):
    cfg = _cfg()
    mesh = tmesh.LogicalMesh((2, 2, 1), AXES, "cpu")
    groups = [TWO, TWO]
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", THGS, SA, lr=LR,
                                     groups=groups)
    batch = _batch(cfg, 8, 32)

    def fresh(seed):
        lm = fsdp.shard(_model(cfg, seed), mesh, "pod", groups=TWO)
        return lm, ttrain.init_fl_residuals(lm, 2, mesh, "pod",
                                            groups=groups)

    lm, rows = fresh(0)
    step(lm, rows, batch, threefry.key(0))
    checkpoint.save(str(tmp_path), 1, fl_train.fl_state(lm, rows))
    step(lm, rows, batch, threefry.key(1))

    # the reference's own restore reads it: params whole, residuals
    # [2, *leaf] in bf16
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("yi_6b")),
                               dtype="float32")
    pshapes = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
    like = {"params": pshapes, "residuals": jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((2,) + x.shape, jnp.bfloat16),
        pshapes)}
    ref = jstore.restore(str(tmp_path), 1, like)
    assert jax.tree_util.tree_leaves(ref["residuals"])[0].dtype == \
        jnp.bfloat16
    lm2, rows2 = fresh(1)
    fl_train.load_fl_state(lm2, rows2, checkpoint.restore(
        str(tmp_path), 1, like=fl_train.fl_state(lm2, rows2)))
    ref_p = convert.lm_tree_to_numpy(lm2, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(ref["params"]),
                    jax.tree_util.tree_leaves(ref_p)):
        assert (np.asarray(a) == b).all()
    for r, want in zip(ttrain.stacked_residuals(rows2),
                       jax.tree_util.tree_leaves(ref["residuals"])):
        assert (r.float().numpy() == np.asarray(want.astype(jnp.float32))
                ).all()
    # resumed: step 2 replays bit for bit
    step(lm2, rows2, batch, threefry.key(1))
    assert all(_same(lm.full(n), lm2.full(n)) for n in lm.shapes)
    for a, b in zip(ttrain.stacked_residuals(rows),
                    ttrain.stacked_residuals(rows2)):
        assert _same(a, b)


# --------------------------------------------------------------- the CLI
def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--log-every",
         "1", *args], capture_output=True, text=True, env=ENV, cwd=cwd,
        timeout=600)


def test_cli_four_devices_run_as_one_device(tmp_path):
    four = _cli("--devices", "cpu,cpu,cpu,cpu", "--steps", "2", "--ckpt",
                str(tmp_path / "a"), cwd=tmp_path)
    one = _cli("--device", "cpu", "--steps", "2", "--ckpt",
               str(tmp_path / "b"), cwd=tmp_path)
    assert four.returncode == 0 and one.returncode == 0, four.stderr
    losses = [ln for ln in four.stdout.splitlines() if "loss=" in ln]
    assert len(losses) == 2
    assert losses == [ln for ln in one.stdout.splitlines() if "loss=" in ln]
    with np.load(tmp_path / "a" / "step_00000002.npz") as a, \
            np.load(tmp_path / "b" / "step_00000002.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    three = _cli("--devices", "cpu,cpu,cpu", "--steps", "1", "--ckpt",
                 str(tmp_path / "c"), cwd=tmp_path)
    assert three.returncode == 1 and "4" in three.stderr
