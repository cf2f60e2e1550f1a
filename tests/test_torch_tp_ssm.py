"""Port: the head-split Mamba2 mixer and xLSTM cells of ``launch/tp.py``
(``ssm_mixer``, ``xlstm_cell``, ``GridView.cols``) against
``models/ssm.ssd_forward``, ``models/xlstm.slstm_forward`` /
``mlstm_forward`` and the JAX reference.

A data group's model positions share the CPU through an explicit grid
(``((cpu,) * m, range(0, 1))``), as in ``tests/test_torch_tp.py``. Inputs
and cotangents come from a numpy seed; every block leaf is redrawn from one
as well (``A_log``, ``D``, ``dt_bias`` too), so a head that reads another
head's columns shows.

* **The blocks** on the same input as the one-device block (``x +
  ssd_forward(norm(x))``, ``x + slstm_forward(x)``, ``x +
  mlstm_forward(x)``), reduced Zamba2-7B (16 SSM heads of 32 channels,
  ``n_groups`` 1, and a variant with 2) and xLSTM-125M (4 heads of 128),
  f32, at model 2, 3 (16 SSM heads as 5/5/6; every leaf whole: 3 divides
  none of their split dims) and 4, xLSTM also at 8 (4 positions without a
  head), on split streams and whole ones. The output, the input's gradient
  and every leaf's gradient (each chunk's partials folded in position
  order) are within ``Y_TOL`` / ``GX_REL`` / ``GRAD_REL`` of the
  one-device block's:
  ``in_proj`` / ``w_in`` / ``w_qkv`` products over fewer columns and the
  row-parallel out projection's partial sums round otherwise, the
  recurrences not at all (each depends on its head's columns alone).
* **Reads.** Each position reads through ``GridView.chunk`` only the
  chunks its heads' columns overlap, and the bytes it reads of other
  positions' chunks equal a hand count; positions without a head read no
  weight of the cell.
* **The reference.** The dense steps of reduced Zamba2-7B and xLSTM-125M on
  ``(data 1, model 2)`` against the reference's real ``jax.jit`` step on a
  2-device Auto mesh (a subprocess started with the module), with the
  tolerances of ``tests/test_torch_tp.py``.
* **Bits.** Two grid steps from one state are bit-equal, and so are
  positions on ``[cpu, cpu:0]`` and on ``[cpu, cpu]``.
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

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import fsdp, tp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
       "JAX_PLATFORMS": "cpu"}
AXES = ("data", "model")
CPU = torch.device("cpu")
# about 2x the largest readings over the cases below (f32, the CPU): the
# block's output max |diff| 4.77e-07; the input's gradient 6.76e-07 of its
# max |g| (the mLSTM at model 3); each leaf's gradient 9.49e-06 of its max
# |g| (the mixer's A_log at model 4 on a whole stream), under the families'
# f32 bound of 2e-5
Y_TOL = 1e-6
GX_REL = 1.5e-6
GRAD_REL = 2e-5
# the reference's tolerances (tests/test_torch_tp.py)
LOSS_TOL, LEAF_REL, PARAM_TOL = 2e-5, 1e-4, 1e-6
LR = 0.01
B = 2
SSM = "ssm_blocks.0.0."
SLSTM, MLSTM = "slstm.0.", "mlstm.0."
# (m, T): split where m divides T, else whole on every position
SSM_CASES = [(2, 32), (2, 31), (3, 32), (4, 32), (4, 30)]
GROUP_CASES = [(2, 32), (3, 32), (4, 32)]
XLSTM_CASES = [(2, 32), (3, 32), (4, 32), (4, 30), (8, 32)]


def grid(m: int, devices=None) -> list:
    return [(tuple(devices or (CPU,) * m), range(0, 1))]


def _cfg(arch: str, n_groups: int = 1):
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                              dtype="float32")
    if n_groups != 1:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=n_groups))
    return cfg


def _model(cfg, seed: int = 0):
    """The port's init with every block leaf redrawn from a numpy seed:
    matrices at the init's scale, ``A_log`` in [0, 2.8), ``D`` about 1,
    ``dt_bias`` about 0, biases small."""
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    rs = np.random.RandomState(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith(("ssm_blocks.", "slstm.", "mlstm.")):
                continue
            leaf = name.rsplit(".", 1)[1]
            if leaf == "A_log":
                draw = rs.uniform(0.0, 2.8, p.shape)
            elif leaf in ("D", "scale"):
                draw = 1.0 + 0.1 * rs.randn(*p.shape)
            elif p.dim() == 1 or leaf == "conv_w":
                draw = 0.1 * rs.randn(*p.shape)
            else:
                d_in, d_out = p.shape[-2:]
                draw = rs.randn(*p.shape) * (2.0 / (d_in + d_out)) ** 0.5
            p.copy_(torch.from_numpy(draw.astype(np.float32)))
    return model


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().reshape(-1).numpy().view(np.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((_bits(a) == _bits(b)).all())


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _lm(cfg, m: int, model=None, devices=None):
    return fsdp.shard(_model(cfg) if model is None else model,
                      tmesh.LogicalMesh((1, m), AXES, "cpu"),
                      groups=grid(m, devices))


def _inputs(cfg, t: int, seed: int = 7):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(B, t, cfg.d_model).astype(np.float32))
    cot = torch.from_numpy(rs.randn(B, t, cfg.d_model).astype(np.float32))
    return x, cot


def _one_device(cfg, prefix: str):
    """The one-device block under ``prefix``: ``fn(p, x)`` on its nested
    leaves."""
    if prefix == SSM:
        return lambda p, x: x + ssm_mod.ssd_forward(
            p["ssm"], apply_norm(p["norm"], x, cfg.norm), cfg.ssm)[0]
    run = (xlstm_mod.slstm_forward if prefix == SLSTM
           else xlstm_mod.mlstm_forward)
    return lambda p, x: x + run(p, x, cfg.n_heads)[0]


def _reference(model, cfg, prefix, x, cot):
    """(y, the input's gradient, {leaf: gradient}) of ``<block(x), cot>``
    on one device."""
    leaves = {n[len(prefix):]: t.detach().clone().requires_grad_(True)
              for n, t in model.named_parameters() if n.startswith(prefix)}
    x = x.clone().requires_grad_(True)
    y = _one_device(cfg, prefix)(tp.nested(leaves, "", leaves.get), x)
    grads = torch.autograd.grad((y * cot).sum(), [x, *leaves.values()])
    return y.detach(), grads[0], dict(zip(leaves, grads[1:]))


def _grid_block(lm, cfg, prefix, x, cot):
    """The block under ``prefix`` over the grid on ``x`` in the stream's
    layout: (the whole output, the input's gradient, {leaf: gradient, each
    chunk's partials folded in position order}, whether the stream is
    split). A whole stream's cotangent goes to position 0's copy."""
    view = tp.GridView(lm, 0)
    st = tp.Stream(view.devices, x.shape[1])
    xs = [t.clone().requires_grad_(True) for t in st.inputs(x)]
    fn = tp.ssm_mixer if prefix == SSM else tp.xlstm_cell
    with torch.enable_grad():
        ys = fn(view, prefix, cfg, st, xs)
        if st.split:
            y = torch.cat([t.detach() for t in ys], 1)
            loss = sum((t * c).sum() for t, c in zip(ys, cot.chunk(view.m,
                                                                   1)))
        else:
            assert all(_same(t, ys[0]) for t in ys)
            y, loss = ys[0].detach(), (ys[0] * cot).sum()
        reads = [r for r in view.reads if r[1][0].startswith(prefix)]
        grads = torch.autograd.grad(loss, xs + [a for _, _, a in reads],
                                    allow_unused=True)
    gx = (torch.cat(grads[:view.m], 1) if st.split
          else tp.fold(grads[:view.m], CPU))
    parts: dict = {}
    for (j, key, _), g in sorted(zip(reads, grads[view.m:]),
                                 key=lambda r: r[0][0]):
        if g is not None:
            parts.setdefault(key, []).append(g)
    out: dict = {}
    for name in sorted({k[0] for k in parts}):
        keys = sorted((k for k in parts if k[0] == name),
                      key=lambda k: -1 if k[2] is None else k[2])
        chunks = [tp.fold(parts[k], CPU) for k in keys]
        md = lm.mdims[name]
        out[name[len(prefix):]] = (chunks[0] if md is None
                                   else torch.cat(chunks, md))
    return y, gx, out, st.split


def _check_block(cfg, prefix, m, t):
    model = _model(cfg)
    lm = _lm(cfg, m, model)
    x, cot = _inputs(cfg, t)
    y_want, gx_want, g_want = _reference(model, cfg, prefix, x, cot)
    y, gx, grads, split = _grid_block(lm, cfg, prefix, x, cot)
    assert split == (t % m == 0)
    assert float((y - y_want).abs().max()) <= Y_TOL
    assert _rel(gx, gx_want) <= GX_REL
    assert sorted(grads) == sorted(g_want)
    for name, w in g_want.items():
        assert _rel(grads[name], w) <= GRAD_REL, name
        assert bool(grads[name].ne(0).any()), name
    return lm


# ------------------------------------------------------------- the blocks
@pytest.mark.parametrize("m,t", SSM_CASES,
                         ids=[f"m{m}-T{t}" for m, t in SSM_CASES])
def test_mixer_against_ssd_forward(m, t):
    lm = _check_block(_cfg("zamba2_7b"), SSM, m, t)
    # model 2 and 4 split in_proj's columns off head boundaries
    assert (lm.mdims[SSM + "ssm.in_proj"] is not None) == (m != 3)


@pytest.mark.parametrize("m,t", GROUP_CASES,
                         ids=[f"m{m}-T{t}" for m, t in GROUP_CASES])
def test_mixer_with_two_groups(m, t):
    """Two B/C groups of 8 heads: at model 3, position 1's heads 5-9 read
    both groups, positions 0 and 2 one each."""
    cfg = _cfg("zamba2_7b", n_groups=2)
    assert [ssm_mod.head_groups(*tp._span(j, m, 16), 16, cfg.ssm)
            for j in range(m)] == {2: [(0, 1), (1, 2)],
                                   3: [(0, 1), (0, 2), (1, 2)],
                                   4: [(0, 1), (0, 1), (1, 2), (1, 2)]}[m]
    _check_block(cfg, SSM, m, t)


@pytest.mark.parametrize("prefix", [SLSTM, MLSTM], ids=["slstm", "mlstm"])
@pytest.mark.parametrize("m,t", XLSTM_CASES,
                         ids=[f"m{m}-T{t}" for m, t in XLSTM_CASES])
def test_cells_against_their_forwards(prefix, m, t):
    _check_block(_cfg("xlstm_125m"), prefix, m, t)


def test_head_columns_by_hand():
    """Reduced Zamba2-7B (d_inner 512, 16 heads of 32, N 16, one group):
    heads 5-9's in_proj columns are z 160-320, x 512 + 160-320, B and C
    1024-1056 and dt 1056 + 5-10; their conv channels x 160-320, B and C
    512-544. With two groups of 8 heads, heads 8-15 read group 1's B and
    C alone."""
    spec = _cfg("zamba2_7b").ssm
    proj, conv = ssm_mod.head_columns(256, spec, 5, 10)
    assert proj == [(160, 320), (672, 832), (1024, 1056), (1061, 1066)]
    assert conv == [(160, 320), (512, 544)]
    two = _cfg("zamba2_7b", n_groups=2).ssm     # 8 heads a group
    proj, conv = ssm_mod.head_columns(256, two, 8, 16)
    assert proj == [(256, 512), (768, 1024), (1040, 1056), (1072, 1088),
                    (1096, 1104)]
    assert conv == [(256, 512), (528, 544), (560, 576)]


# -------------------------------------------------------------- the reads
def _spied_reads(monkeypatch, prefixes):
    """``[(j, leaf name, i, bytes)]`` of every ``GridView.chunk`` read of a
    leaf under ``prefixes``, and ``[(j, leaf name)]`` of every
    ``GridView.cols`` call."""
    chunks, cols = [], []
    real_chunk, real_cols = tp.GridView.chunk, tp.GridView.cols

    def chunk(self, j, name, i, *args):
        out = real_chunk(self, j, name, i, *args)
        if name.startswith(prefixes):
            chunks.append((j, name, i, out.numel() * out.element_size()))
        return out

    def col(self, j, name, *args):
        if name.startswith(prefixes):
            cols.append((j, name))
        return real_cols(self, j, name, *args)

    monkeypatch.setattr(tp.GridView, "chunk", chunk)
    monkeypatch.setattr(tp.GridView, "cols", col)
    return chunks, cols


def _across(chunks) -> dict:
    """``{(j, leaf, i): bytes}`` of the reads of other positions'
    chunks."""
    out: dict = {}
    for j, name, i, n in chunks:
        if i != j:
            key = (j, name.rsplit(".", 1)[1], i)
            out[key] = out.get(key, 0) + n
    return out


def test_mixer_reads_only_the_chunks_its_heads_overlap(monkeypatch):
    """Reduced Zamba2-7B at model 2 (in_proj [256, 1072] in chunks of 536
    columns, conv_w [4, 544] in chunks of 272; A_log, D, dt_bias and
    out_proj fall on the heads), one mixer call. Position 0 (heads 0-7)
    reads of chunk 1 x's columns 536-768, B, C and its dt (232 + 32 + 8 =
    272 columns x 256 rows x 4 B) and conv_w's B and C (32 channels x 4 x
    4 B); position 1 (heads 8-15) reads of chunk 0 its z (256 columns) and
    conv_w's x channels 256-272 (16 x 4 x 4 B)."""
    cfg = _cfg("zamba2_7b")
    lm = _lm(cfg, 2)
    chunks, _ = _spied_reads(monkeypatch, (SSM,))
    x, _ = _inputs(cfg, 32)
    view = tp.GridView(lm, 0)
    st = tp.Stream(view.devices, 32)
    tp.ssm_mixer(view, SSM, cfg, st, st.inputs(x))
    assert _across(chunks) == {(0, "in_proj", 1): 272 * 256 * 4,
                               (0, "conv_w", 1): 32 * 4 * 4,
                               (1, "in_proj", 0): 256 * 256 * 4,
                               (1, "conv_w", 0): 16 * 4 * 4}
    own = {(j, n.rsplit(".", 1)[1]) for j, n, i, _ in chunks if i == j}
    # and its own chunk of each leaf (conv_b and the norm's scale whole)
    assert own == {(j, leaf) for j in (0, 1) for leaf in (
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "out_proj",
        "scale")}


def test_cells_read_only_the_chunks_their_heads_overlap(monkeypatch):
    """Reduced xLSTM-125M at model 2 (4 heads of 128, d_inner 512), one
    call of each cell. sLSTM: w_in [256, 2048] in chunks of 1024 holds
    gates z and i of every head in chunk 0, f and o in chunk 1, so each
    position reads the other chunk's two gates of its two heads (512
    columns x 256 rows x 4 B); r [4, 128, 512] splits along dh, so each
    reads the other half of its heads' rows ([2, 64, 512] x 4 B). mLSTM:
    w_qkv [256, 1536] in chunks of 768 holds q and k of heads 0-1 in
    chunk 0, so position 0 reads its v (256 columns) of chunk 1 and
    position 1 its q of chunk 0. w_o, w_out fall on the heads; b, w_if
    are whole."""
    cfg = _cfg("xlstm_125m")
    lm = _lm(cfg, 2)
    x, _ = _inputs(cfg, 32)
    want = {SLSTM: {(0, "w_in", 1): 512 * 256 * 4, (0, "r", 1): 2 * 64 * 512 * 4,
                    (1, "w_in", 0): 512 * 256 * 4, (1, "r", 0): 2 * 64 * 512 * 4},
            MLSTM: {(0, "w_qkv", 1): 256 * 256 * 4,
                    (1, "w_qkv", 0): 256 * 256 * 4}}
    for prefix, across in want.items():
        chunks, _ = _spied_reads(monkeypatch, (prefix,))
        view = tp.GridView(lm, 0)
        st = tp.Stream(view.devices, 32)
        tp.xlstm_cell(view, prefix, cfg, st, st.inputs(x))
        assert _across(chunks) == across, prefix


def test_positions_without_a_head_read_nothing_and_add_zeros(monkeypatch):
    """xLSTM-125M's 4 heads over model 8: positions 0, 2, 4, 6 hold none
    (``_span``), read no weight of either cell and add +0.0 partials; the
    block still equals the one-device block (the cases above)."""
    cfg = _cfg("xlstm_125m")
    assert [j for j in range(8) if tp._span(j, 8, 4)[0]
            == tp._span(j, 8, 4)[1]] == [0, 2, 4, 6]
    lm = _lm(cfg, 8)
    x, _ = _inputs(cfg, 32)
    sent = []
    real = tp.Stream.reduce

    def reduce(self, parts):
        sent.append([p.detach().clone() for p in parts])
        return real(self, parts)

    monkeypatch.setattr(tp.Stream, "reduce", reduce)
    for prefix in (SLSTM, MLSTM):
        _, cols = _spied_reads(monkeypatch, (prefix,))
        view = tp.GridView(lm, 0)
        st = tp.Stream(view.devices, 32)
        tp.xlstm_cell(view, prefix, cfg, st, st.inputs(x))
        assert {j for j, _ in cols} == {1, 3, 5, 7}, prefix
    for parts in sent:
        for j in (0, 2, 4, 6):
            assert _same(parts[j], torch.zeros_like(parts[j]))
        assert all(bool(parts[j].ne(0).any()) for j in (1, 3, 5, 7))


def test_a_step_reads_each_block_at_each_use(monkeypatch):
    """A dense step of reduced Zamba2-7B at model 2 runs each of its two
    mixers three times (the forward, the super-block's recompute and the
    mixer's own) and each run reads one call's bytes above; xLSTM's two
    cells run once each (no checkpoint)."""
    rs = np.random.RandomState(1)
    mixer = (272 + 256) * 256 * 4 + (32 + 16) * 4 * 4
    cells = (2 * (512 * 256 * 4 + 2 * 64 * 512 * 4)       # the sLSTM
             + 2 * 256 * 256 * 4)                          # the mLSTM
    for arch, prefixes, want in (
            ("zamba2_7b", ("ssm_blocks.",), 3 * 2 * mixer),
            ("xlstm_125m", ("slstm.", "mlstm."), cells)):
        cfg = _cfg(arch)
        lm = _lm(cfg, 2)
        batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, (B, 32))
                                     .astype(np.int32))
                 for k in ("tokens", "labels")}
        chunks, _ = _spied_reads(monkeypatch, prefixes)
        fsdp.step_gradients(lm, cfg, batch)
        assert sum(_across(chunks).values()) == want, arch


def test_no_mixer_weight_is_saved_outside_the_remats():
    cfg = _cfg("zamba2_7b")
    lm = _lm(cfg, 2)
    shapes = {n: tuple(lm.chunks[0][n].shape) for n in lm.shapes}
    # the mixers' matrices' chunk shapes that no other leaf shares (lm_head's
    # chunk, saved at the loss, is out_proj's)
    ssm = ({v for n, v in shapes.items()
            if n.startswith("ssm_blocks.") and len(v) > 1}
           - {v for n, v in shapes.items() if not n.startswith("ssm_blocks.")})
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    rs = np.random.RandomState(1)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, (B, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        loss = tp.train_loss(tp.GridView(lm, 0), cfg, batch)
    assert loss.requires_grad and saved and ssm
    assert not ssm & set(saved), sorted(ssm & set(saved))


# ---------------------------------------------------------- the reference
REF_SSM = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.models import transformer as tf
from repro.models.sharding import logical_axis_rules
from repro.launch import shardings as shd
from repro.launch.mesh import logical_rules
from repro.launch.train import make_dense_train_step
archs, out_path, lr, B, T = json.loads(sys.argv[1])
out = {}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
rules = logical_rules(mesh)
for arch in archs:
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                              dtype="float32")
    params0 = tf.init_params(cfg, jax.random.key(0))
    rs = np.random.RandomState(5)
    batch_np = {"tokens": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32),
                "labels": rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)}
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
    out[arch] = {
        "batch": batch_np, "p0": jax.tree_util.tree_map(np.asarray, params0),
        "loss": float(loss), "step_loss": float(step_loss),
        "grads": jax.tree_util.tree_map(np.asarray, grads),
        "p": jax.tree_util.tree_map(np.asarray, p)}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""
REF_ARCHS = ["zamba2_7b", "xlstm_125m"]
REF_B, REF_T = 4, 32


@pytest.fixture(scope="module")
def ssm_ref(tmp_path_factory):
    """The reference's dense step of each of ``REF_ARCHS`` on a (1, 2)
    Auto mesh, in a subprocess started with the module."""
    out = tmp_path_factory.mktemp("ssm_ref") / "ssm.pkl"
    arg = json.dumps([REF_ARCHS, str(out), LR, REF_B, REF_T])
    proc = subprocess.Popen([sys.executable, "-c", REF_SSM, arg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, env=ENV)
    result: dict = {}

    def get() -> dict:
        if not result:
            try:
                _, err = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
            assert proc.returncode == 0, err[-3000:]
            with open(out, "rb") as f:
                result.update(pickle.load(f))
        return result

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_dense_step_matches_the_reference_mesh(arch, ssm_ref):
    want = ssm_ref()[arch]
    cfg = _cfg(arch)
    mesh = tmesh.LogicalMesh((1, 2), AXES, "cpu")
    lm = fsdp.shard_reference(want["p0"], cfg, mesh, groups=grid(2))
    split = {n.rsplit(".", 1)[1] for n in lm.shapes
             if n.startswith(("ssm_blocks.", "slstm.", "mlstm."))
             and lm.mdims[n] is not None}
    assert split == ({"in_proj", "conv_w", "A_log", "D", "dt_bias",
                      "out_proj"} if arch == "zamba2_7b" else
                     {"w_in", "r", "w_qkv", "w_o", "w_out"})
    batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
    loss, grads = fsdp.step_gradients(lm, cfg, batch)
    assert abs(float(loss) - want["loss"]) <= LOSS_TOL
    got_g = _flat(convert.lm_tree_to_numpy(
        {n: grads.full(n, CPU) for n in lm.shapes}, cfg))
    for path, w in _flat(want["grads"]).items():
        gap = np.abs(got_g[path] - w).max() / max(np.abs(w).max(), 1e-30)
        assert gap <= LEAF_REL, (path, gap)
    _, step_loss = ttrain.make_dense_train_step(cfg, LR, mesh=None)(lm,
                                                                   batch)
    assert abs(float(step_loss) - want["step_loss"]) <= LOSS_TOL
    got_p = _flat(convert.lm_tree_to_numpy(lm, cfg))
    for path, w in _flat(want["p"]).items():
        np.testing.assert_allclose(got_p[path], w, rtol=0, atol=PARAM_TOL,
                                   err_msg=path)


# ------------------------------------------------------------------ bits
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_two_steps_and_two_placements_are_bit_equal(arch):
    """Two grid steps from one state, and positions on ``cpu`` and on
    ``cpu:0`` (another device object: the reads move tensors between
    them), give the same bits."""
    cfg = _cfg(arch)
    rs = np.random.RandomState(2)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, (B, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    runs = []
    for devices in (None, None, [CPU, torch.device("cpu", 0)]):
        lm = _lm(cfg, 2, devices=devices)
        loss, grads = fsdp.step_gradients(lm, cfg, batch)
        runs.append((loss, {n: grads.full(n, CPU) for n in lm.shapes}))
    for loss, grads in runs[1:]:
        assert _same(loss, runs[0][0])
        assert all(_same(grads[n], g) for n, g in runs[0][1].items())
