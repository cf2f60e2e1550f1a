"""Port: the FL encode in place (``launch/train.py``'s
``_FLStep.encode_blocks`` and ``FLTrainStepV2``), against the port's
one-device step and the JAX reference.

Without a card there is one device with data (the CPU), and ``meta``. A
participant's model positions (and data groups) share the CPU through an
explicit list, as in ``tests/test_torch_tp.py`` and
``tests/test_torch_fsdp.py``.

* **The aligned view's blocks are boxes.** Block ``b`` of the reference's
  ``sharding_aligned_transform`` is the box of ``aligned_block_cuts`` (a
  chunk of the leaf along its split dims) flattened row-major, for every
  leaf of three families on (2, 1, 2), (2, 2, 1) and (2, 2, 2).
* **Bit for bit.** A step spread over a participant grid and the one-device
  step, fed the same gradients (the port's own, on each participant's rows
  of a seeded batch) and residuals, on one logical mesh: every stream,
  residual row and parameter is bit-equal. v2 on (2, 1, 2) with model
  positions, (2, 2, 1) with data groups and (2, 2, 2); v2 with
  ``REPRO_FL_V2_GENERIC=1`` and v1 with ``REPRO_FL_ALIGNED_BLOCKS=1`` on
  the same grids; MoE and hybrid-SSM families at (2, 1, 2). The grid's v2
  fed the reference's gradients is bit-equal to the reference-built v2
  oracle of ``tests/test_torch_fl_train.py`` at (2, 1, 2).
* **What moves.** ``gathered_bytes`` is 0 on every aligned leaf, and on a
  generic leaf that the grid splits it is the leaf's gradient and residual
  bytes a participant; ``home_bytes`` is the streams' bytes. Each block is
  encoded on the device of its chunk (a grid of ``cpu`` and ``meta``
  cells).
* **One participant at a time.** v2 lets participant 0's gradients go
  before it asks for participant 1's (``weakref``), on one device and on a
  grid.
"""
import dataclasses
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.core import blocked as jblocked  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import streams as se  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.blocked import sharding_aligned_transform  # noqa: E402
from repro_torch.core.types import SecureAggConfig, THGSConfig  # noqa: E402
from repro_torch.launch import fsdp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fl_train as flt  # noqa: E402

AXES = ("pod", "data", "model")
CPU, META = torch.device("cpu"), torch.device("meta")
THGS = THGSConfig(**flt.THGS)
SA = SecureAggConfig(mask_ratio=flt.MASK_RATIO)
LR, B, T = flt.LR, 8, 32
KEY = threefry.fold_in(threefry.key(9), 4)
DATA_GROUPS = [(CPU, range(0, 1)), (CPU, range(1, 2))]


def grid(m: int, n_groups: int = 1, device=CPU) -> list:
    """``n_groups`` data groups of one position, each ``m`` model positions
    on ``device``."""
    return [((device,) * m, range(g, g + 1)) for g in range(n_groups)]


GRIDS = {"212": ((2, 1, 2), grid(2)), "221": ((2, 2, 1), DATA_GROUPS),
         "222": ((2, 2, 2), grid(2, 2))}


def _cfg(arch: str = "yi_6b"):
    return dataclasses.replace(configs.reduced(configs.get(arch)),
                               dtype="float32")


def _model(cfg, seed: int = 0):
    return tf.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (_bits(a) == _bits(b)).all())


_STATE: dict = {}


def _state(arch: str):
    """The port's model, each participant's gradients on its rows of a
    seeded batch, and seeded bf16 residuals ``[2, *leaf]`` (cached)."""
    if arch not in _STATE:
        cfg = _cfg(arch)
        model = _model(cfg)
        rs = np.random.RandomState(3)
        batch = {"labels": torch.from_numpy(
            rs.randint(0, cfg.vocab, (B, T)).astype(np.int32))}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(
                rs.randn(B, T, cfg.d_model).astype(np.float32))
        else:
            batch["tokens"] = torch.from_numpy(
                rs.randint(0, cfg.vocab, (B, T)).astype(np.int32))
        rows = B // 2
        grads = [ttrain.value_and_grad(
            model, cfg, {k: v[p * rows:(p + 1) * rows]
                         for k, v in batch.items()})[1] for p in range(2)]
        res = [torch.from_numpy((0.01 * rs.randn(2, *lf.shape))
                                .astype(np.float32)).to(torch.bfloat16)
               for lf in convert.reference_leaves(model)]
        _STATE[arch] = cfg, {n: p.detach().clone() for n, p in
                             model.named_parameters()}, grads, res
    return _STATE[arch]


def as_grads(lm: fsdp.ShardedLM, whole: dict) -> fsdp.Grads:
    """Whole gradients in ``lm``'s layout: each cell's block, on its
    device."""
    return fsdp.Grads(lm, [
        {n: lm.block(c, n, whole[n]).clone().to(lm.cells[c][2])
         for n in lm.shapes} for c in range(len(lm.cells))])


def _mk(version):
    return (ttrain.make_fl_train_step if version == "v1"
            else ttrain.make_fl_train_step_v2)


def one_device(arch, shape, version):
    """The one-device step's exchange: ``(params, stacked residuals,
    record)``."""
    cfg, state, grads, res = _state(arch)
    model = _model(cfg)
    model.load_state_dict(state)
    rows = [r.clone() for r in res]
    step = _mk(version)(cfg, tmesh.LogicalMesh(shape, AXES, "cpu"), "pod",
                        THGS, SA, lr=LR)
    rec: list = []
    step.exchange(model, rows, [dict(g) for g in grads], KEY, record=rec)
    return {n: p.detach() for n, p in model.named_parameters()}, rows, rec


def on_grid(arch, shape, groups, version, grads=None):
    """The exchange of the step over ``groups`` (every participant's):
    ``(params, stacked residuals, record, the residual rows)``."""
    cfg, state, own, res = _state(arch)
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    model = _model(cfg)
    model.load_state_dict(state)
    lm = fsdp.shard(model, mesh, "pod", groups=groups)
    rows = ttrain.init_fl_residuals(lm, 2, mesh, "pod", groups=[groups] * 2)
    ttrain.load_residuals(rows, res)
    step = _mk(version)(cfg, mesh, "pod", THGS, SA, lr=LR,
                        groups=[groups] * 2)
    rec: list = []
    step.exchange(lm, rows, [as_grads(lm, g) for g in
                             (own if grads is None else grads)], KEY,
                  record=rec)
    return ({n: lm.full(n) for n in lm.shapes},
            ttrain.stacked_residuals(rows), rec, rows)


def _stream_pairs(record, version) -> list:
    if version == "v2":
        return [(r["streams"].indices, r["streams"].values) for r in record]
    return [(torch.stack([s.indices for s in r["streams"]]),
             torch.stack([s.values for s in r["streams"]])) for r in record]


def check_bit_equal(arch, key, version):
    shape, groups = GRIDS[key]
    want_p, want_r, want_rec = one_device(arch, shape, version)
    got_p, got_r, got_rec, _ = on_grid(arch, shape, groups, version)
    assert [r["leaf"] for r in got_rec] == [r["leaf"] for r in want_rec]
    for (a, b), (c, d), r in zip(_stream_pairs(got_rec, version),
                                 _stream_pairs(want_rec, version), got_rec):
        assert _same(a, c) and _same(b, d), r["leaf"]
    for lid, (a, b) in enumerate(zip(got_r, want_r)):
        assert _same(a, b), lid
    assert all(_same(got_p[n], want_p[n]) for n in want_p)
    assert any(r.any() for r in want_r)
    return got_rec


# ------------------------------------------------- the aligned view's boxes
@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b", "zamba2_7b"])
@pytest.mark.parametrize("shape", [(2, 1, 2), (2, 2, 1), (2, 2, 2)],
                         ids=str)
def test_aligned_blocks_are_boxes_of_the_reference_view(arch, shape):
    """Block ``b`` of the reference's (and the port's) aligned view is the
    box ``aligned_block_cuts`` gives, flattened row-major."""
    meta = tf.init_params(_cfg(arch), device="meta")
    leaves = convert.reference_leaves(meta)
    axis_sizes = dict(zip(AXES, shape))
    rules = tmesh.logical_rules(tmesh.LogicalMesh(shape, AXES, "meta"),
                                fed_axis="pod")
    rs = np.random.RandomState(0)
    seen = 0
    for lf in leaves:
        spec = shd.param_specs({lf.path: lf.shape}, rules,
                               axis_sizes)[lf.path]
        jtr = jblocked.sharding_aligned_transform(
            lf.shape, PartitionSpec(*spec), axis_sizes, AXES[1:])
        ttr = sharding_aligned_transform(lf.shape, spec, axis_sizes,
                                         AXES[1:])
        assert (jtr is None) == (ttr is None), lf.path
        if jtr is None:
            continue
        x = rs.randn(*lf.shape).astype(np.float32)
        want = np.asarray(jtr[0](x))
        cuts = ttrain.aligned_block_cuts(lf.shape, spec, axis_sizes,
                                         AXES[1:])
        assert len(cuts) == jtr[2] == want.shape[0], lf.path
        assert _same(ttr[0](torch.from_numpy(x)), torch.from_numpy(want))
        for b, cut in enumerate(cuts):
            box = ttrain._narrow(torch.from_numpy(x), cut)
            assert _same(box.reshape(-1), torch.from_numpy(want[b])), \
                (lf.path, b)
        seen += 1
    assert seen


def test_box_of_stacked_parameters_stacks_each_parameters_box():
    """``_box`` of a stacked leaf stacks the same box of each port
    parameter (a view for an unstacked leaf) and refuses a cut of a
    stacked dim, which ``param_specs`` never splits."""
    gen = torch.Generator().manual_seed(0)
    whole = torch.randn((2, 3, 4, 6), generator=gen)
    leaf = convert.RefLeaf("w", (2, 3, 4, 6), (2, 3),
                           tuple(f"b{i}" for i in range(6)))
    tensors = {f"b{i}": whole.reshape(6, 4, 6)[i] for i in range(6)}
    cut = {2: (1, 2), 3: (3, 3)}
    assert _same(ttrain._box(tensors, leaf, cut), ttrain._narrow(whole, cut))
    with pytest.raises(ValueError, match="stacked"):
        ttrain._box(tensors, leaf, {1: (0, 2)})
    one = convert.RefLeaf("v", (4, 6), (), ("b0",))
    assert ttrain._box(tensors, one, {1: (0, 3)}).data_ptr() == \
        tensors["b0"].data_ptr()


# ------------------------------------------------------------ bit for bit
@pytest.mark.parametrize("key", sorted(GRIDS))
def test_v2_grid_exchange_is_bit_equal_to_the_one_device_exchange(key):
    check_bit_equal("yi_6b", key, "v2")


def test_v2_one_block_a_call_is_bit_equal_to_batched_blocks(monkeypatch):
    """On (2, 2, 2) (4 blocks a participant on the CPU) the one-device and
    grid exchanges with one block an encode call give the batched calls'
    bits."""
    want_p, want_r, want_rec = one_device("yi_6b", (2, 2, 2), "v2")
    monkeypatch.setattr(ttrain, "ENCODE_ELEMS", 1)
    for got_p, got_r, got_rec in (
            one_device("yi_6b", (2, 2, 2), "v2"),
            on_grid("yi_6b", *GRIDS["222"], "v2")[:3]):
        for (a, b), (c, d) in zip(_stream_pairs(got_rec, "v2"),
                                  _stream_pairs(want_rec, "v2")):
            assert _same(a, c) and _same(b, d)
        assert all(_same(a, b) for a, b in zip(got_r, want_r))
        assert all(_same(got_p[n], want_p[n]) for n in want_p)


@pytest.mark.parametrize("key", sorted(GRIDS))
def test_v2_generic_grid_exchange_is_bit_equal(key, monkeypatch):
    monkeypatch.setenv("REPRO_FL_V2_GENERIC", "1")
    check_bit_equal("yi_6b", key, "v2")


@pytest.mark.parametrize("key", sorted(GRIDS))
def test_v1_aligned_grid_exchange_is_bit_equal(key, monkeypatch):
    monkeypatch.setenv("REPRO_FL_ALIGNED_BLOCKS", "1")
    check_bit_equal("yi_6b", key, "v1")


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "zamba2_7b"])
@pytest.mark.parametrize("version", ["v2", "v1"])
def test_other_families_on_a_model_grid_are_bit_equal(arch, version,
                                                      monkeypatch):
    if version == "v1":
        monkeypatch.setenv("REPRO_FL_ALIGNED_BLOCKS", "1")
    check_bit_equal(arch, "212", version)


@pytest.mark.parametrize("per_call", ["batched", "one-a-call"])
def test_v2_grid_with_reference_gradients_is_the_reference_oracle(
        per_call, monkeypatch):
    """The (2, 1, 2) grid's v2 exchange fed the reference's gradients and
    residuals is bit-equal to ``oracle_v2`` (the reference's
    ``encode_batch_blocks`` and scatter, jitted), with a device's blocks
    batched into one encode call and with one block a call (a block above
    ``ENCODE_ELEMS``, as Yi-6B's at full size)."""
    if per_call == "one-a-call":
        monkeypatch.setattr(ttrain, "ENCODE_ELEMS", 1)
    shape = (2, 1, 2)
    p0, grad_trees = flt._reference_gradients({}, 2)
    rs = np.random.RandomState(4)
    res_np = [(0.01 * rs.randn(2, *x.shape)).astype(np.float32)
              for x in jax.tree_util.tree_leaves(p0)]
    jres = [r.astype(jax.numpy.bfloat16).astype(np.float32) for r in res_np]
    w_streams, w_res, w_p = flt.oracle_v2(
        p0, [jax.tree_util.tree_leaves(g) for g in grad_trees], jres,
        jax.random.fold_in(jax.random.key(9), 4), shape,
        flt.JTHGS(**flt.THGS), flt.JSA(mask_ratio=flt.MASK_RATIO), LR,
        generic=False)
    cfg = _cfg()
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    groups = grid(2)
    lm = fsdp.shard(convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, p0), cfg), mesh, "pod",
        groups=groups)
    rows = ttrain.init_fl_residuals(lm, 2, mesh, "pod", groups=[groups] * 2)
    ttrain.load_residuals(rows, [torch.from_numpy(r).to(torch.bfloat16)
                                 for r in res_np])
    grads = [as_grads(lm, {
        n: t.detach() for n, t in convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, g), cfg).named_parameters()})
        for g in grad_trees]
    step = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", THGS, SA, lr=LR,
                                        groups=[groups] * 2)
    rec: list = []
    step.exchange(lm, rows, grads, KEY, record=rec)
    assert len(rec) == len(w_streams)
    for r in rec:
        w_idx, w_vals = w_streams[(r["leaf"], None)]
        assert flt._bits_equal(w_idx, r["streams"].indices), r["leaf"]
        assert flt._bits_equal(w_vals, r["streams"].values), r["leaf"]
    leaves = convert.reference_leaves(lm.meta)
    got_p = flt._flat(convert.lm_tree_to_numpy(lm, cfg))
    for lid, (leaf, got_r) in enumerate(zip(
            leaves, ttrain.stacked_residuals(rows))):
        assert flt._bits_equal(w_res[lid], got_r), leaf.path
        assert flt._bits_equal(w_p[lid], torch.from_numpy(got_p[leaf.path])), \
            leaf.path


# ------------------------------------------------------------ what moves
def _aligned(arch, shape) -> list:
    """Whether each reference leaf has the aligned view on ``shape``."""
    step = ttrain.make_fl_train_step_v2(
        _cfg(arch), tmesh.LogicalMesh(shape, AXES, "cpu"), "pod", THGS, SA)
    leaves, specs, _, _ = step.layout(tf.init_params(_cfg(arch),
                                                     device="meta"))
    return [sharding_aligned_transform(lf.shape, sp, step.axis_sizes,
                                       step.intra_axes) is not None
            for lf, sp in zip(leaves, specs)]


def _home_bytes(r) -> int:
    sts = [r["streams"]] if isinstance(r["streams"], se.StreamBatch) \
        else r["streams"]
    return sum(t.numel() * t.element_size() for st in sts
               for t in (st.indices, st.values))


@pytest.mark.parametrize("key", sorted(GRIDS))
def test_aligned_leaves_gather_nothing(key):
    shape, groups = GRIDS[key]
    aligned = _aligned("yi_6b", shape)
    assert any(aligned)
    _, _, rec, _ = on_grid("yi_6b", shape, groups, "v2")
    assert all(r["gathered_bytes"] == 0 for r in rec
               if aligned[r["leaf"]]), [(r["leaf"], r["gathered_bytes"])
                                        for r in rec]
    assert all(r["home_bytes"] == _home_bytes(r) > 0 for r in rec)


@pytest.mark.parametrize("version", ["v2", "v1"])
@pytest.mark.parametrize("key", sorted(GRIDS))
def test_generic_leaves_gather_their_bytes(key, version, monkeypatch):
    """Generic row blocks (v2 with ``REPRO_FL_V2_GENERIC=1``, v1's
    default) gather a split leaf whole on the lead device: its gradient
    (bf16 in v2, f32 here in v1) and its bf16 residual, a participant; a
    leaf in one chunk gathers nothing."""
    if version == "v2":
        monkeypatch.setenv("REPRO_FL_V2_GENERIC", "1")
    shape, groups = GRIDS[key]
    _, _, rec, rows = on_grid("yi_6b", shape, groups, version)
    leaves = convert.reference_leaves(tf.init_params(_cfg(), device="meta"))
    g_size = 2 if version == "v2" else 4
    split = 0
    for r in rec:
        n = int(np.prod(leaves[r["leaf"]].shape))
        if len(rows[r["leaf"]][0].parts) > 1:
            split += 1
            assert r["gathered_bytes"] == 2 * n * (g_size + 2), r["leaf"]
        else:
            assert r["gathered_bytes"] == 0, r["leaf"]
        assert r["home_bytes"] == _home_bytes(r)
    assert split


def test_each_block_is_encoded_on_its_cell(monkeypatch):
    """A grid of a ``cpu`` and a ``meta`` cell: a leaf split over model
    encodes block 1 on ``meta`` (its gradient, residual and mask row
    there), block 0 on the CPU; a leaf whole along model on cell 0."""
    cfg = _cfg()
    shape = (2, 1, 2)
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    groups = [((CPU, META), range(0, 1))]
    lm = fsdp.shard(_model(cfg), mesh, "pod", groups=groups)
    rows = ttrain.init_fl_residuals(lm, 2, mesh, "pod", groups=[groups] * 2)
    _, _, grads, _ = _state("yi_6b")
    seen = []

    def spy(acc, k, *, pair_signs=None, k_mask=0, masks=None, **kw):
        seen.append((acc.device, None if masks is None
                     else masks[0].device))
        kt = k + (0 if masks is None else masks[0].shape[-1])
        rows = acc.shape[1]
        return se.StreamBatch(torch.zeros((1, rows, kt), dtype=torch.int32),
                              torch.zeros((1, rows, kt))), acc

    monkeypatch.setattr(se, "encode_batch_blocks", spy)
    step = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", THGS, SA, lr=LR,
                                        groups=[groups] * 2)
    rec: list = []
    step.exchange(lm, rows, [as_grads(lm, g) for g in grads], KEY,
                  record=rec)
    aligned = _aligned("yi_6b", shape)
    assert all(r["gathered_bytes"] == 0 for r in rec)
    n_blocks = [len(r["streams"].indices[0]) for r in rec]
    at = 0
    for lid, nb in enumerate(n_blocks):
        calls = seen[at:at + (nb if aligned[lid] else 1)]
        at += len(calls)
        if aligned[lid] and nb == 2:
            assert calls == [(CPU, CPU), (META, META)], lid
        else:
            assert calls == [(CPU, CPU)] * len(calls), lid
    assert at == len(seen) // 2     # participant 1 repeats participant 0


# ------------------------------------------------ one participant at a time
class _Tracked(dict):
    """A gradient dict that a weak reference can follow."""


@pytest.mark.parametrize("where", ["one-device", "grid"])
def test_v2_lets_a_participant_go_before_asking_for_the_next(where):
    cfg, state, grads, res = _state("yi_6b")
    shape, groups = GRIDS["212"]
    mesh = tmesh.LogicalMesh(shape, AXES, "cpu")
    model = _model(cfg)
    model.load_state_dict(state)
    if where == "grid":
        params = fsdp.shard(model, mesh, "pod", groups=groups)
        rows = ttrain.init_fl_residuals(params, 2, mesh, "pod",
                                        groups=[groups] * 2)
        ttrain.load_residuals(rows, res)
        step = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", THGS, SA,
                                            lr=LR, groups=[groups] * 2)
    else:
        params, rows = model, [r.clone() for r in res]
        step = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", THGS, SA,
                                            lr=LR)
    refs, asked = [], []

    def feed():
        for p in range(2):
            asked.append([r() is None for r in refs])
            if where == "grid":
                g = as_grads(params, grads[p])
                tensors = [t for c in g.chunks for t in c.values()]
            else:
                g = _Tracked({n: t.clone() for n, t in grads[p].items()})
                tensors = list(g.values())
            refs.append(weakref.ref(g))
            refs.extend(weakref.ref(t) for t in tensors)
            del tensors
            yield g
            del g

    step.exchange(params, rows, feed(), KEY)
    assert len(asked) == 2 and asked[0] == [] and all(asked[1]), asked
