"""Port: tensor parallelism over ``model`` inside one participant
(``launch/mesh.py::participant_groups``' grids, ``launch/fsdp.py``'s 2-D
placement, ``launch/tp.py``), against the JAX reference.

Without a card there is one device with data (the CPU), and ``meta``. A
participant's model positions share the CPU through an explicit grid
(``((cpu, cpu), range(0, 1))``: one device a model position), as two
data groups share it in ``tests/test_torch_fsdp.py``.

* **Placement.** Every family at (2, 2, 2) and (2, 16, 16) with model
  positions on ``cpu`` / ``meta``: each cell's chunk is the reference's
  ``NamedSharding(...).shard_shape`` (its group's data shards
  concatenated), and its bytes ``dryrun.shard_bytes``' a position.
* **Collectives.** Each is exact (sums in position order from partial 0,
  in f32, as numpy adds them), its backward is its adjoint (``<f(x), y> =
  <x, f*(y)>`` with ``f*`` built from the others), and positions on
  ``cpu`` and on ``cpu:0`` (a second device object) give the same bits.
* **The dense step** against the reference's real step on Auto-axis
  meshes (1, 2), (2, 2) and (1, 4) of 4 fake CPU devices (a subprocess
  started with the module): reduced Yi-6B in f32, B 4 x T 32. Loss within
  2e-5, each gradient leaf within 1e-4 of its max |g|, the params after
  one SGD step (lr 0.01) within 1e-6 (the one-device tolerances of
  ``tests/test_torch_train.py``). Model 2 splits Yi-6B's K/V by KV head
  (2 KV heads, one a position); model 4 gathers them (one query head a
  position, 2 KV heads).
* **Every family at model 2** against the port's one-device step: the
  loss within ``FAMILY_LOSS_TOL``, each gradient leaf within
  ``FAMILY_GRAD_REL`` of its max |g| (the partial sums of the row-parallel
  products and the vocab-parallel loss add in another order), the params
  after one step within 1e-6; two runs bit-equal; model 3 (a whole
  residual stream: 3 does not divide T) and model 4 too.
* **The FL steps** v1 and v2 at (2, 1, 2), model positions on an explicit
  grid, against the reference's real (2, 1, 2) step
  (``tests/test_torch_fl_train.py``'s script and tolerances).
* **Checkpoints and the CLI**: a checkpoint of a grid's parameters and
  2-D residual rows is the reference's layout and resumes bit for bit;
  ``fl_train --devices`` takes one device a (pod, data, model) position.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import checkpoint, configs, convert  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.types import SecureAggConfig, THGSConfig  # noqa: E402
from repro_torch.launch import dryrun, fl_train, fsdp, tp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fl_train import (ReferenceRun,  # noqa: E402
                                 check_free_running)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
AXES = ("pod", "data", "model")
CPU, META = torch.device("cpu"), torch.device("meta")
LOSS_TOL, GRAD_REL, PARAM_TOL = 2e-5, 1e-4, 1e-6
# the port's own one-device step against its grid: measured <= 4.8e-7 on
# the loss and <= 4.7e-6 of a leaf's max |g| (every family, model 2 and 4)
FAMILY_LOSS_TOL, FAMILY_GRAD_REL = 5e-6, 5e-5
LR = 0.01
DENSE_B, DENSE_T = 4, 32
THGS = THGSConfig(s0=0.1, alpha=0.9, s_min=0.01)
SA = SecureAggConfig(mask_ratio=0.05)


def grid(m: int, n_groups: int = 1, device=CPU) -> list:
    """``n_groups`` data groups of one position, each ``m`` model positions
    on ``device``."""
    return [((device,) * m, range(g, g + 1)) for g in range(n_groups)]


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


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


# ------------------------------------------------------------ the grids
def test_participant_grids_share_one_layout():
    mesh = tmesh.LogicalMesh((2, 2, 2), AXES, [
        [["cpu", "meta"], ["cpu", "meta"]], [["cpu", "cpu"]] * 2])
    assert tmesh.participant_groups(mesh, "pod", 0) == [
        ((CPU, META), range(0, 2))]
    assert tmesh.participant_groups(mesh, "pod", 1) == [(CPU, range(0, 2))]
    assert tmesh.participant_grids(mesh, "pod") == [
        [((CPU, META), range(0, 2))], [((CPU, CPU), range(0, 2))]]
    with pytest.raises(ValueError, match="mix"):
        fsdp.check_groups([((CPU, CPU), range(0, 1)), (CPU, range(1, 2))], 2)
    with pytest.raises(ValueError, match="cells"):
        fsdp.empty(_cfg(), tmesh.LogicalMesh((1, 2), AXES[1:], "cpu"),
                   groups=grid(4))


# -------------------------------------------------------------- placement
def _reference_specs(arch: str, shape) -> dict:
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    pshapes = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
    fake = type("M", (), {"axis_names": AXES,
                          "devices": np.empty(shape, dtype=object)})()
    specs = jshd.param_specs(pshapes, jmesh.logical_rules(fake,
                                                          fed_axis="pod"),
                             fake)
    return {".".join(k.key for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


@pytest.mark.parametrize("arch", configs.all_archs())
@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 16, 16)])
def test_placement_cells_are_the_reference_shards(arch, shape):
    n_data, n_model = shape[1:]
    half = n_data // 2
    devs = np.empty(shape, dtype=object)
    for j in range(n_model):      # two groups, model positions alternating
        devs[:, :half, j] = CPU if j % 2 == 0 else META
        devs[:, half:, j] = META if j % 2 == 0 else CPU
    mesh = tmesh.LogicalMesh(shape, AXES, devs)
    lm = fsdp.empty(_cfg(arch), mesh, "pod")
    assert lm.n_model == n_model and len(lm.groups) == 2
    assert [pos for _, pos in lm.groups] == [range(0, half),
                                             range(half, n_data)]
    flat = _reference_specs(arch, shape)
    full = AbstractMesh(shape, AXES)
    sizes = dict(zip(AXES, shape))
    n_split = 0
    for lf in convert.reference_leaves(lm.meta):
        spec = flat[lf.path]
        shard = NamedSharding(full, spec).shard_shape(lf.shape)
        per = dryrun.shard_bytes(lf.shape, lm.dtypes[lf.names[0]], spec,
                                 sizes)
        d, md = lm.dims[lf.names[0]], lm.mdims[lf.names[0]]
        n_split += md is not None
        for c, (g, j, dev) in enumerate(lm.cells):
            chunk = lm.chunks[c][lf.names[0]]
            want = list(shard)
            n_pos = len(lm.groups[g][1]) if d is not None else 1
            if d is not None:
                want[d + len(lf.lead)] *= n_pos
            assert lf.lead + tuple(chunk.shape) == tuple(want), lf.path
            assert chunk.numel() * chunk.element_size() * int(
                np.prod(lf.lead)) == per * n_pos, lf.path
            assert all(lm.chunks[c][n].device == dev for n in lf.names)
    assert n_split > 0


def test_whole_blocks_have_one_copy_a_device():
    cfg = _cfg("deepseek_moe_16b")      # its router is whole along model
    lm = fsdp.empty(cfg, tmesh.LogicalMesh((1, 2, 2), AXES, "cpu"), "pod",
                    groups=[((CPU, META), range(0, 1)),
                            ((CPU, CPU), range(1, 2))])
    whole = [n for n in lm.shapes
             if lm.dims[n] is None and lm.mdims[n] is None]
    model_whole = [n for n in lm.shapes
                   if lm.dims[n] is not None and lm.mdims[n] is None]
    assert whole and model_whole
    for n in whole:     # one copy a device: cpu's shared by three cells
        assert lm.chunks[0][n] is lm.chunks[2][n] is lm.chunks[3][n]
        assert lm.chunks[1][n].device == META
    for n in model_whole:   # one copy a (group, device)
        assert lm.chunks[2][n] is lm.chunks[3][n]
        assert lm.chunks[0][n] is not lm.chunks[2][n]
    model = _model(cfg)
    cpu_lm = fsdp.shard(model, tmesh.LogicalMesh((1, 2, 2), AXES, "cpu"),
                        "pod", groups=grid(2, 2))
    assert all(_same(cpu_lm.full(n), p) for n, p in model.named_parameters())
    back = fsdp.ShardedLM(cfg, [((CPU, CPU), range(0, 2))], 2, cpu_lm.dims,
                          cpu_lm.mdims)
    back.refresh_from(cpu_lm)
    assert all(_same(back.full(n), p) for n, p in model.named_parameters())
    with pytest.raises(ValueError, match="layout"):
        back.refresh_from(fsdp.shard(model, tmesh.LogicalMesh(
            (1, 2, 1), AXES, "cpu"), "pod", groups=[(CPU, range(0, 2))]))


# ------------------------------------------------------------ collectives
def _parts(m: int, shape=(2, 8, 3), dtype=torch.float32, seed=0) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(shape, generator=gen) * 10 ** i).to(dtype)
            for i in range(m)]


def _np_sum(parts) -> np.ndarray:
    acc = parts[0].float().numpy().copy()
    for p in parts[1:]:
        acc = (acc + p.float().numpy()).astype(np.float32)
    return acc


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sums_add_in_position_order(m, dtype):
    parts = _parts(m, (2, 12, 3), dtype)
    want = torch.from_numpy(_np_sum(parts)).to(dtype)
    assert _same(tp.fold(parts, CPU), want)
    assert all(_same(x, want) for x in tp.all_reduce(parts))
    assert _same(tp.reduce_to(parts, CPU), want)
    rs = tp.reduce_scatter(parts, 1)
    assert all(_same(x, want[:, i * (12 // m):(i + 1) * (12 // m)])
               for i, x in enumerate(rs))
    # another order rounds differently: the order is what is pinned
    if dtype == torch.float32 and m > 2:
        other = torch.from_numpy(_np_sum(parts[::-1]))
        assert not _same(other, want)


@pytest.mark.parametrize("m", [2, 4])
def test_moves_are_exact(m):
    xs = _parts(m)
    whole = torch.cat(xs, 1)
    assert all(_same(x, whole) for x in tp.all_gather(xs, 1))
    assert all(_same(x, xs[0]) for x in tp.broadcast(xs[0], [CPU] * m))
    assert all(_same(x, whole[:, 8 * i:8 * (i + 1)]) for i, x in
               enumerate(tp.scatter(whole, [CPU] * m, 1)))
    feats = _parts(m, (2, 8, 4))      # [B, T, d/m] a position
    out = tp.all_to_all(feats, 1, 2)
    rows = torch.cat(feats, 2)
    per = 8 // m
    assert all(_same(x, rows[:, i * per:(i + 1) * per])
               for i, x in enumerate(out))


def _adjoint_gap(fn, xs, ys_like, seed=1) -> float:
    """``|<f(x), y> - <x, f*(y)>|`` relative, ``f*`` the backward."""
    gen = torch.Generator().manual_seed(seed)
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    outs = fn(xs)
    outs = outs if isinstance(outs, list) else [outs]
    ys = [torch.randn(o.shape, generator=gen, dtype=torch.float64)
          .float() for o in outs]
    lhs = sum(float((o.detach().double() * y.double()).sum())
              for o, y in zip(outs, ys))
    grads = torch.autograd.grad(outs, xs, ys)
    rhs = sum(float((x.detach().double() * g.double()).sum())
              for x, g in zip(xs, grads))
    return abs(lhs - rhs) / max(abs(lhs), 1e-30)


@pytest.mark.parametrize("name", ["all_gather", "reduce_scatter",
                                  "all_reduce", "all_to_all", "broadcast",
                                  "scatter", "reduce_to"])
def test_each_backward_is_the_adjoint(name):
    m = 4
    fns = {
        "all_gather": (lambda xs: tp.all_gather(xs, 1), _parts(m)),
        "reduce_scatter": (lambda xs: tp.reduce_scatter(xs, 1), _parts(m)),
        "all_reduce": (tp.all_reduce, _parts(m)),
        "all_to_all": (lambda xs: tp.all_to_all(xs, 1, 2),
                       _parts(m, (2, 8, 4))),
        "broadcast": (lambda xs: tp.broadcast(xs[0], [CPU] * m),
                      _parts(1)),
        "scatter": (lambda xs: tp.scatter(xs[0], [CPU] * m, 1),
                    _parts(1)),
        "reduce_to": (lambda xs: tp.reduce_to(xs, CPU), _parts(m)),
    }
    fn, xs = fns[name]
    assert _adjoint_gap(fn, xs, None) < 1e-6


def test_backwards_are_the_pairs():
    """All-gather's backward is reduce-scatter's forward and back, bit for
    bit; all-reduce's is itself."""
    xs, gs = _parts(3), _parts(3, (2, 24, 3), seed=4)
    xs = [x.requires_grad_(True) for x in xs]
    got = torch.autograd.grad(tp.all_gather(xs, 1), xs, gs)
    want = tp.reduce_scatter(gs, 1)
    assert all(_same(a, b) for a, b in zip(got, want))
    ps = [p.requires_grad_(True) for p in _parts(3, (2, 24, 3))]
    gs2 = _parts(3, (2, 8, 3), seed=5)
    got = torch.autograd.grad(tp.reduce_scatter(ps, 1), ps, gs2)
    assert all(_same(g, torch.cat(gs2, 1)) for g in got)
    ps = [p.detach().requires_grad_(True) for p in ps]
    got = torch.autograd.grad(tp.all_reduce(ps), ps, gs)
    assert all(_same(g, w) for g, w in zip(got, tp.all_reduce(gs)))


def test_placement_moves_no_bit():
    """Positions on ``cpu`` and on ``cpu:0`` (another device object: the
    placement code moves tensors between them) compute the same bits."""
    two = [CPU, torch.device("cpu", 0)]
    xs = _parts(2)
    moved = [x.to(d) for x, d in zip(xs, two)]
    assert all(_same(a, b) for a, b in zip(tp.all_reduce(xs),
                                           tp.all_reduce(moved)))
    cfg = _cfg()
    batch = _batch(cfg, 2, 32)
    mesh = tmesh.LogicalMesh((1, 2), AXES[1:], [two])
    assert tmesh.participant_groups(mesh, None) == [(tuple(two),
                                                     range(0, 1))]
    a = fsdp.shard(_model(cfg), mesh)
    b = fsdp.shard(_model(cfg), mesh, groups=grid(2))
    la, ga = fsdp.step_gradients(a, cfg, batch)
    lb, gb = fsdp.step_gradients(b, cfg, batch)
    assert _same(la, lb)
    assert all(_same(ga.full(n, CPU), gb.full(n, CPU)) for n in a.shapes)


def test_remat_saves_only_its_inputs_and_hands_back_param_gradients():
    gen = torch.Generator().manual_seed(2)
    w = torch.randn((4, 4), generator=gen).requires_grad_(True)
    x = torch.randn((3, 4), generator=gen).requires_grad_(True)

    def fn(x):
        return (torch.tanh(x @ w) @ w, x)       # an input passed through

    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, same = tp.remat(fn, (x,), (w,))
    assert saved == [(3, 4)] and same is not x
    gx, gw = torch.autograd.grad((y.sum() + same.sum()), (x, w))
    y2, _ = fn(x)
    gx2, gw2 = torch.autograd.grad(y2.sum() + x.sum(), (x, w))
    assert _same(y, y2) and _same(gx, gx2) and _same(gw, gw2)


def test_block_weights_are_not_saved_outside_the_remats():
    cfg = _cfg()
    lm = fsdp.shard(_model(cfg), tmesh.LogicalMesh((1, 2), AXES[1:], "cpu"),
                    groups=grid(2))
    blocks = set()
    for n in lm.shapes:
        if n.startswith("blocks."):
            blocks |= {lm.shapes[n], tuple(lm.chunks[0][n].shape)}
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    view = tp.GridView(lm, 0)
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        loss = tp.train_loss(view, cfg, _batch(cfg, 2, 32))
    # the final norm's scale and the vocab chunks are saved at the loss
    blocks -= {lm.shapes["final_norm.scale"],
               tuple(lm.chunks[0]["lm_head"].shape)}
    assert loss.requires_grad and saved and blocks
    assert not blocks & set(saved), sorted(blocks & set(saved))


# ---------------------------------------------- the dense step, reference
REF_DENSE = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.models import transformer as tf
from repro.models.sharding import logical_axis_rules
from repro.launch import shardings as shd
from repro.launch.mesh import logical_rules
from repro.launch.train import make_dense_train_step
shapes, out_path, lr, B, T = json.loads(sys.argv[1])
cfg = dataclasses.replace(configs.reduced(configs.get("yi_6b")),
                          dtype="float32")
params0 = tf.init_params(cfg, jax.random.key(0))
rs = np.random.RandomState(5)
batch_np = {"tokens": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32),
            "labels": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)}
out = {"batch": batch_np}
for shape in shapes:
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    rules = logical_rules(mesh)
    pshapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params0)
    params = jax.device_put(params0, shd.named(
        shd.param_specs(pshapes, rules, mesh), mesh))
    batch = jax.device_put({k: jnp.asarray(v) for k, v in batch_np.items()},
                           NamedSharding(mesh, P("data", None)))
    with logical_axis_rules(mesh, rules):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: tf.train_loss(p, cfg, b)))(params, batch)
        p, step_loss = jax.jit(make_dense_train_step(cfg, lr))(params, batch)
    out[str(tuple(shape))] = {
        "loss": float(loss), "step_loss": float(step_loss),
        "grads": jax.tree_util.tree_map(np.asarray, grads),
        "p": jax.tree_util.tree_map(np.asarray, p)}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""
DENSE_SHAPES = [(1, 2), (2, 2), (1, 4)]


class DenseReference:
    """The reference's dense step (and its gradients) on each of
    ``DENSE_SHAPES``, in a subprocess started at once."""

    def __init__(self, tmp_path):
        self.out = tmp_path / "dense.pkl"
        arg = json.dumps([[list(s) for s in DENSE_SHAPES], str(self.out),
                          LR, DENSE_B, DENSE_T])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_DENSE, arg], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env={**ENV, "JAX_PLATFORMS": "cpu"})
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            try:
                _, err = self.proc.communicate(timeout=600)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
            assert self.proc.returncode == 0, err[-3000:]
            with open(self.out, "rb") as f:
                self._result = pickle.load(f)
        return self._result

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def dense_ref(tmp_path_factory):
    job = DenseReference(tmp_path_factory.mktemp("dense"))
    yield job
    job.close()


@pytest.fixture(scope="module")
def fl_ref(tmp_path_factory):
    job = ReferenceRun((2, 1, 2), tmp_path_factory.mktemp("ref212"))
    yield job
    job.close()


@pytest.fixture(scope="module", autouse=True)
def references(dense_ref, fl_ref):
    """Both reference runs start when the module does."""
    yield


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=str)
def test_dense_step_matches_the_reference_mesh(shape, dense_ref):
    ref = dense_ref.result()
    want = ref[str(shape)]
    cfg = _cfg()
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("yi_6b")),
                               dtype="float32")
    p0 = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.key(0)))
    mesh = tmesh.LogicalMesh(shape, AXES[1:], "cpu")
    groups = grid(shape[1], shape[0])
    lm = fsdp.shard_reference(p0, cfg, mesh, groups=groups)
    assert lm.n_model == shape[1] and len(lm.groups) == shape[0]
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, grads = fsdp.step_gradients(lm, cfg, batch)
    assert abs(float(loss) - want["loss"]) <= LOSS_TOL
    got_g = _flat(convert.lm_tree_to_numpy(
        {n: grads.full(n, CPU) for n in lm.shapes}, cfg))
    for path, w in _flat(want["grads"]).items():
        gap = np.abs(got_g[path] - w).max() / max(np.abs(w).max(), 1e-30)
        assert gap <= GRAD_REL, (path, gap)
    _, step_loss = ttrain.make_dense_train_step(cfg, LR, mesh=None)(lm,
                                                                   batch)
    assert abs(float(step_loss) - want["step_loss"]) <= LOSS_TOL
    got_p = _flat(convert.lm_tree_to_numpy(lm, cfg))
    for path, w in _flat(want["p"]).items():
        np.testing.assert_allclose(got_p[path], w, rtol=0, atol=PARAM_TOL,
                                   err_msg=path)


def test_model_four_gathers_kv_and_model_two_splits_it(monkeypatch):
    """Yi-6B reduced (4 query heads, 2 KV heads): at model 2 each position
    reads its own ``wk`` / ``wv`` chunk; at model 4 none does (each
    position's query head needs half a chunk pair), so every position
    gathers them whole."""
    cfg = _cfg()
    batch = _batch(cfg, 2, 32)
    for m, own in ((2, True), (4, False)):
        lm = fsdp.shard(_model(cfg), tmesh.LogicalMesh((1, m), AXES[1:],
                                                       "cpu"),
                        groups=grid(m))
        reads = []
        real = tp.GridView.chunk

        def spy(self, j, name, i, _real=real):
            if name.endswith("attn.wk"):
                reads.append((j, i))
            return _real(self, j, name, i)

        monkeypatch.setattr(tp.GridView, "chunk", spy)
        fsdp.step_gradients(lm, cfg, batch)
        monkeypatch.setattr(tp.GridView, "chunk", real)
        if own:
            assert reads and all(j == i for j, i in reads)
        else:
            assert {i for j, i in reads if j == 0} == set(range(m))


# ------------------------------------------------------ every family, model 2
@pytest.mark.parametrize("arch", configs.all_archs())
def test_every_family_matches_its_one_device_step(arch):
    cfg = _cfg(arch)
    batch = _batch(cfg, 2, 32)
    one = _model(cfg)
    l1, g1 = ttrain.value_and_grad(one, cfg, batch)
    mesh = tmesh.LogicalMesh((1, 2), AXES[1:], "cpu")
    lm = fsdp.shard(_model(cfg), mesh, groups=grid(2))
    l2, g2 = fsdp.step_gradients(lm, cfg, batch)
    l3, g3 = fsdp.step_gradients(lm, cfg, batch)
    assert abs(float(l1) - float(l2)) <= FAMILY_LOSS_TOL
    for n, w in g1.items():
        assert _rel(g2.full(n, CPU), w) <= FAMILY_GRAD_REL, n
    assert _same(l2, l3)
    assert all(_same(g2.full(n, CPU), g3.full(n, CPU)) for n in g1)
    ttrain.sgd_update(one, g1, LR)
    fsdp.sgd_update(lm, g2, LR)
    for n, p in one.named_parameters():
        assert float((lm.full(n) - p).abs().max()) <= PARAM_TOL, n


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b", "zamba2_7b",
                                  "xlstm_125m", "llama32_vision_90b"])
@pytest.mark.parametrize("m,T", [(3, 32), (4, 32), (4, 30)],
                         ids=["whole-3", "split-4", "whole-4"])
def test_wider_grids_and_a_whole_stream(arch, m, T):
    cfg = _cfg(arch)
    batch = _batch(cfg, 2, T)
    l1, g1 = ttrain.value_and_grad(_model(cfg), cfg, batch)
    lm = fsdp.shard(_model(cfg), tmesh.LogicalMesh((1, m), AXES[1:], "cpu"),
                    groups=grid(m))
    l2, g2 = fsdp.step_gradients(lm, cfg, batch)
    assert abs(float(l1) - float(l2)) <= FAMILY_LOSS_TOL
    for n, w in g1.items():
        assert _rel(g2.full(n, CPU), w) <= FAMILY_GRAD_REL, n


def test_grid_with_data_groups_and_microbatches_folds_in_order():
    """Two data groups of two model positions each are the one-group grid
    with twice the microbatches, bit for bit."""
    cfg = _cfg()
    batch = _batch(cfg, 4, 32)
    mesh = tmesh.LogicalMesh((2, 2), AXES[1:], "cpu")
    two = fsdp.shard(_model(cfg), mesh, groups=grid(2, 2))
    one = fsdp.shard(_model(cfg), tmesh.LogicalMesh((1, 2), AXES[1:], "cpu"),
                     groups=grid(2))
    la, ga = fsdp.step_gradients(two, cfg, batch)
    lb, gb = fsdp.step_gradients(one, cfg, batch, 2)
    assert _same(la, lb)
    assert all(_same(ga.full(n, CPU), gb.full(n, CPU)) for n in two.shapes)
    assert {t.dtype for c in ga.chunks for t in c.values()} == {
        torch.float32}
    with pytest.raises(ValueError, match="f32"):
        fsdp.step_gradients(one, cfg, batch, 2, f32=False)
    # one group of one microbatch: the f32 sums rounded to the dtype once
    lc, gc = fsdp.step_gradients(one, cfg, batch)
    ld, gd = fsdp.step_gradients(one, cfg, batch, f32=True)
    assert _same(lc, ld)
    assert all(_same(gc.full(n, CPU), gd.full(n, CPU)) for n in one.shapes)


def test_bf16_grid_step_stays_near_the_one_device_step():
    cfg = _cfg("yi_6b", "bfloat16")
    batch = _batch(cfg, 2, 32)
    l1, g1 = ttrain.value_and_grad(_model(cfg), cfg, batch)
    lm = fsdp.shard(_model(cfg), tmesh.LogicalMesh((1, 2), AXES[1:], "cpu"),
                    groups=grid(2))
    l2, g2 = fsdp.step_gradients(lm, cfg, batch)
    # the bf16 tolerances of tests/test_torch_train.py against the reference
    assert abs(float(l1) - float(l2)) <= 2e-3
    for n, w in g1.items():
        assert _rel(g2.full(n, CPU), w) <= 5e-2, n


# ------------------------------------------------------------ the FL steps
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_fl_steps_match_the_reference_212(version, fl_ref):
    check_free_running(fl_ref.result(), (2, 1, 2), version,
                       groups=grid(2))


def test_fl_step_rows_lie_on_the_grid():
    cfg = _cfg()
    mesh = tmesh.LogicalMesh((2, 1, 2), AXES, "cpu")
    lm = fsdp.shard(_model(cfg), mesh, "pod", groups=grid(2))
    rows = ttrain.init_fl_residuals(lm, 2, mesh, "pod", groups=[grid(2)] * 2)
    dims = {(r.dim, r.mdim, len(r.parts)) for row in rows for r in row}
    assert (None, None, 1) in dims and any(
        md is not None and n == 2 for _, md, n in dims)
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", THGS, SA, lr=0.05,
                                     groups=[grid(2)] * 2)
    assert not step.f32     # one group of one microbatch keeps the dtype
    _, _, loss = step(lm, rows, _batch(cfg, 8, 32), threefry.key(0))
    assert torch.isfinite(loss)
    assert any(r.any() for r in ttrain.stacked_residuals(rows))


def test_chunked_row_on_a_grid_reads_and_writes_slices():
    gen = torch.Generator().manual_seed(1)
    full = torch.randn((3, 4, 6), generator=gen)
    parts = [full[:, a * 2:(a + 1) * 2, b * 3:(b + 1) * 3].clone()
             for a in range(2) for b in range(2)]
    row = fsdp.ChunkedRow(parts, 1, 2, 2)
    assert row.shape == (3, 4, 6) and _same(row.cpu(), full)
    for i in range(3):
        assert _same(row.slice_to(3, (4, 6), i, CPU), full[i])
    new = torch.randn((4, 6), generator=gen)
    row.put_slice(3, (4, 6), 1, new)
    full[1] = new
    assert _same(row.cpu(), full)
    other = torch.randn((3, 4, 6), generator=gen)
    row.copy_(other)
    assert _same(row.cpu(), other)
    only_model = fsdp.ChunkedRow([other[..., :3].clone(),
                                  other[..., 3:].clone()], None, 2, 2)
    assert _same(only_model.to(CPU), other)


# ------------------------------------------------------------ checkpoints
def test_grid_checkpoint_is_the_reference_layout_and_resumes(tmp_path):
    cfg = _cfg()
    mesh = tmesh.LogicalMesh((2, 2, 2), AXES, "cpu")
    groups = grid(2, 2)
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", THGS, SA, lr=0.05,
                                     groups=[groups] * 2)
    batch = _batch(cfg, 8, 32)

    def fresh(seed):
        lm = fsdp.shard(_model(cfg, seed), mesh, "pod", groups=groups)
        return lm, ttrain.init_fl_residuals(lm, 2, mesh, "pod",
                                            groups=[groups] * 2)

    lm, rows = fresh(0)
    step(lm, rows, batch, threefry.key(0))
    checkpoint.save(str(tmp_path), 1, fl_train.fl_state(lm, rows))
    step(lm, rows, batch, threefry.key(1))
    lm2, rows2 = fresh(1)
    fl_train.load_fl_state(lm2, rows2, checkpoint.restore(
        str(tmp_path), 1, like=fl_train.fl_state(lm2, rows2)))
    # the on-disk params are the whole model: the one-device layout reads
    flat = _flat(convert.lm_tree_to_numpy(lm2, cfg))
    plain = _model(cfg, 2)
    fl_train.load_params_tree(plain, {
        k: torch.from_numpy(v) for k, v in flat.items()})
    assert all(_same(plain.get_parameter(n), lm2.full(n))
               for n in lm2.shapes)
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


def test_cli_takes_one_device_a_model_position(tmp_path):
    devices = [CPU if i % 2 == 0 else META for i in range(8)]
    mesh = fl_train.cli_mesh(devices, CPU)
    assert mesh.devices.shape == (2, 2, 2)
    assert tmesh.participant_groups(mesh, "pod", 1) == [((CPU, META),
                                                         range(0, 2))]
    with pytest.raises(ValueError, match="8"):
        fl_train.cli_mesh(devices[:6], CPU)
    eight = _cli("--devices", ",".join(["cpu"] * 8), "--steps", "2",
                 "--ckpt", str(tmp_path / "a"), cwd=tmp_path)
    one = _cli("--device", "cpu", "--steps", "2", "--ckpt",
               str(tmp_path / "b"), cwd=tmp_path)
    assert eight.returncode == 0 and one.returncode == 0, eight.stderr
    losses = [ln for ln in eight.stdout.splitlines() if "loss=" in ln]
    assert len(losses) == 2
    assert losses == [ln for ln in one.stdout.splitlines() if "loss=" in ln]
    six = _cli("--devices", ",".join(["cpu"] * 6), "--steps", "1",
               "--ckpt", str(tmp_path / "c"), cwd=tmp_path)
    assert six.returncode == 1 and "8" in six.stderr
