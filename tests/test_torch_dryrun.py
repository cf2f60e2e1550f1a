"""Port parity: the dry run on the meta device (``launch/dryrun.py``) and the
roofline over its records (``bench/paper/roofline.py``) against
``repro.launch.dryrun`` and the repo-root ``benchmarks/roofline.py``.

* the roofline's formulas equal the reference's for every arch x shape;
* every parameter and input leaf's spec and shard shape equal the
  reference's (``launch/shardings.param_specs``, ``specs.input_pspecs``,
  ``NamedSharding(mesh, spec).shard_shape`` on an abstract mesh of the
  production sizes), the decode state's bytes a device equal the
  reference's stacked state's, and the ``long_500k`` rule rewrite;
* the record's keys and the skip record are the reference's;
* one full-size Yi-6B ``train_4k`` record, and its FL twin on the
  multi-pod mesh, on meta in seconds; the layout's collective count,
  hand-counted on a toy mesh, and its tensor-parallel term (traced on
  the meta device at a cut depth and length) equal to the bytes and calls
  a counted ``launch/tp.py`` step returns on a CPU grid, for every arch;
  Yi-6B's tensor-parallel term by hand; ``long_500k``'s folded decode
  (one row over data and model) against a counted (2, 2) CPU grid decode;
* ``chip_smoke.py``'s ``train_flops`` against the meta trace's
  ``FlopCounterMode`` count within 1%, at reduced widths and at Yi-6B's
  B 4 x T 4096 (8.7109e14);
* the roofline CSV through the bench CLI without a card, and the tables;
* neither module loads ``jax``.
"""
import ast
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bench.__main__ import main as bench_main  # noqa: E402
from repro_torch.bench.paper import experiments_tables, roofline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the repo-root ``benchmarks`` package
    sys.path.insert(0, str(ROOT))

from benchmarks import roofline as jroof  # noqa: E402

ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "1"}
ARCHS = tconfigs.all_archs()
SHAPES = list(tspecs.SHAPES)
MESHES = {"single": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model"))}
_N_PARAMS: dict = {}


def _n_params(arch: str, shape: str) -> int:
    key = (arch, shape)
    if key not in _N_PARAMS:
        cfg = tspecs.arch_for_shape(tconfigs.get(arch), tspecs.SHAPES[shape])
        _N_PARAMS[key] = roofline.meta_param_count(cfg)
    return _N_PARAMS[key]


def _cfgs(arch: str, shape: str):
    t = tspecs.arch_for_shape(tconfigs.get(arch), tspecs.SHAPES[shape])
    j = jspecs.arch_for_shape(jconfigs.get(arch), jspecs.SHAPES[shape])
    return t, j


# ------------------------------------------------------------ the roofline
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_formulas_equal_reference(arch, shape):
    tcfg, jcfg = _cfgs(arch, shape)
    ts, js = tspecs.SHAPES[shape], jspecs.SHAPES[shape]
    n = _n_params(arch, shape)
    assert roofline.active_params(tcfg, n) == jroof.active_params(jcfg, n)
    assert roofline.model_flops(tcfg, ts, n) == jroof.model_flops(jcfg, js,
                                                                  n)
    for fl in (False, True):
        assert (roofline.analytic_hbm_bytes(tcfg, ts, n, fl)
                == jroof.analytic_hbm_bytes(jcfg, js, n, fl))
    assert roofline.n_micro_for(n) == jroof.n_micro_for(n)
    assert roofline.scan_correction(tcfg, ts, n) == 1.0


# ---------------------------------------------------------------- the layout
def _ref_mesh(kind: str):
    shape, axes = MESHES[kind]
    # the reference's param_specs reads axis_names and devices.shape
    fake = types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))
    return fake, AbstractMesh(shape, axes)


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *keys, last = path.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _flat_specs(tree) -> dict:
    return {".".join(k.key for k in path): spec
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


@pytest.mark.parametrize("mesh_kind", ["single", "pod"])
@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b", "zamba2_7b",
                                  "llama32_vision_90b", "xlstm_125m",
                                  "hubert_xlarge", "llama4_scout_17b_a16e"])
def test_param_shard_shapes_equal_reference(arch, mesh_kind):
    fake, amesh = _ref_mesh(mesh_kind)
    sizes = dict(zip(MESHES[mesh_kind][1], MESHES[mesh_kind][0]))
    shape = tspecs.SHAPES["train_4k"]
    tcfg, jcfg = _cfgs(arch, "train_4k")
    tmesh = make_production_mesh(multi_pod=mesh_kind == "pod",
                                 device="meta")
    trules = dryrun.step_rules(tmesh, shape, None)
    jrules = jmesh.logical_rules(fake)
    assert trules == jrules
    layout = dryrun.step_layout(tcfg, shape, tmesh, trules, False)
    leaves = {p: s for p, s, _, _ in layout["params"]}
    ref_tree = _nested({p: jax.ShapeDtypeStruct(s, np.float32)
                        for p, s in leaves.items()})
    ref_specs = _flat_specs(jshd.param_specs(ref_tree, jrules, fake))
    assert set(ref_specs) == set(leaves)
    for path, shp, _, spec in layout["params"]:
        assert tuple(spec) == tuple(ref_specs[path]), path
        want = NamedSharding(amesh, ref_specs[path]).shard_shape(shp)
        assert dryrun.shard_shape(shp, spec, sizes) == tuple(want), path


@pytest.mark.parametrize("mesh_kind", ["single", "pod"])
@pytest.mark.parametrize("arch,shape", [("yi_6b", "train_4k"),
                                        ("hubert_xlarge", "prefill_32k"),
                                        ("llama32_vision_90b", "train_4k"),
                                        ("llama32_vision_90b", "prefill_32k"),
                                        ("yi_6b", "decode_32k"),
                                        ("yi_6b", "long_500k"),
                                        ("zamba2_7b", "decode_32k"),
                                        ("xlstm_125m", "decode_32k"),
                                        ("deepseek_moe_16b", "long_500k")])
def test_input_bytes_equal_reference(arch, shape, mesh_kind):
    """Inputs' specs (train, prefill) and the bytes a device holds of every
    input, the decode state included (the port's state is one cache a
    layer, the reference's stacked: the bytes agree)."""
    fake, amesh = _ref_mesh(mesh_kind)
    sizes = dict(zip(MESHES[mesh_kind][1], MESHES[mesh_kind][0]))
    ts = tspecs.SHAPES[shape]
    tcfg, jcfg = _cfgs(arch, shape)
    tmesh = make_production_mesh(multi_pod=mesh_kind == "pod",
                                 device="meta")
    trules = dryrun.step_rules(tmesh, ts, None)
    jrules = jmesh.logical_rules(fake)
    if ts.global_batch == 1:     # the reference's run_one rewrite
        b = jrules["batch"] if isinstance(jrules["batch"], tuple) \
            else (jrules["batch"],)
        jrules = {**jrules, "kv_seq": tuple(a for a in b if a) + ("model",),
                  "batch": None}
    assert trules == jrules
    layout = dryrun.step_layout(tcfg, ts, tmesh, trules, False)
    got = sum(dryrun.shard_bytes(s, dt, spec, sizes)
              for name, leaves in layout.items() if name != "params"
              for _, s, dt, spec in leaves)
    jins = jspecs.input_specs(jcfg, jspecs.SHAPES[shape])
    jps = jspecs.input_pspecs(jcfg, jspecs.SHAPES[shape], jrules)
    want = 0
    for (_, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(jins)[0],
            jax.tree_util.tree_flatten_with_path(
                jps, is_leaf=lambda x: isinstance(x, JP))[0]):
        blk = NamedSharding(amesh, spec).shard_shape(leaf.shape)
        want += math.prod(blk) * np.dtype(leaf.dtype).itemsize
    assert got == want
    if ts.kind != "decode":
        tps = tspecs.input_pspecs(tcfg, ts, trules)
        flat = (tps["batch"] if ts.kind == "train" else tps)
        jflat = (jps["batch"] if ts.kind == "train" else jps)
        assert {k: tuple(v) for k, v in flat.items()} == \
            {k: tuple(v) for k, v in jflat.items()}


# ----------------------------------------------------------------- records
def _ref_record_keys() -> set:
    """The keys ``repro/launch/dryrun.py::run_one`` gives a record of
    status ok: its first dict literal's and ``rec.update``'s keywords."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_one")
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "rec"
                        for t in node.targets)
                and any(isinstance(k, ast.Constant) and k.value == "fl"
                        for k in node.value.keys)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and any(kw.arg == "memory" for kw in node.keywords)):
            keys |= {kw.arg for kw in node.keywords}
    return keys


def test_skip_record_equals_reference(tmp_path):
    code = ("import json, sys\n"
            "from repro.launch import dryrun\n"
            "rec = dryrun.run_one('hubert_xlarge', 'decode_32k', 'single', "
            "out_dir=sys.argv[1])\n"
            "print(json.dumps(rec))\n")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path / "ref")],
                       capture_output=True, text=True, env=ENV,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    want = json.loads(p.stdout.strip().splitlines()[-1])
    got = dryrun.run_one("hubert_xlarge", "decode_32k", "single",
                         out_dir=str(tmp_path / "port"))
    assert got == want
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref")) == ["hubert_xlarge__decode_32k__single"
                                          ".json"]


def test_yi6b_train_records_on_meta(tmp_path):
    """A full-size Yi-6B train_4k record in seconds, with the reference's
    keys; its FLOP count is the global batch's; the FL twin on the
    multi-pod mesh adds the residuals, the round key and the exchange."""
    t0 = time.perf_counter()
    rec = dryrun.run_one("yi_6b", "train_4k", "single",
                         out_dir=str(tmp_path))
    assert time.perf_counter() - t0 < 30
    assert rec["status"] == "ok", rec.get("traceback")
    assert _ref_record_keys() <= set(rec)
    assert json.loads((tmp_path / "yi_6b__train_4k__single.json")
                      .read_text()) == json.loads(json.dumps(rec))
    assert not list(tmp_path.glob("*.tmp"))
    n = _n_params("yi_6b", "train_4k")
    assert rec["n_params"] == n == 6061035520
    cost = rec["cost"]
    assert cost["calls"] == 2 and cost["flops"] * 256 == cost["flops_total"]
    # above 6 N D: remat recompute and the full attention square
    assert 1.2 < cost["flops_total"] / (6 * n * 256 * 4096) < 1.6
    mem = rec["memory"]
    by = mem["argument_bytes_by_name"]
    assert mem["argument_size_in_bytes"] == sum(by.values())
    assert mem["donated_argument_bytes"] == by["params"]
    assert by["batch"] == 2 * (256 // 16) * 4096 * 4   # tokens, labels
    col = rec["collectives"]
    ops = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute", "weight-reads")
    assert col["total_bytes"] == sum(col[op]["bytes"] for op in ops) > 0
    # launch/tp.py's collectives, by hand, a call (2 calls): model 16
    # splits T 4096, the stream [8 rows, 4096, 4096] bf16 (X bytes). Each
    # of 32 blocks all-gathers its two normed inputs (X) and reduce-scatters
    # its two row-parallel partials (X / 16) in the forward and the
    # recompute, and runs their adjoints once: 128 + 64 all-gathers, 64 +
    # 128 reduce-scatters; the loss's input one more of each. The
    # embedding (its 4096 features split) one all-to-all of X / 16 and its
    # adjoint. The loss's 32 chunks: the max, the exponentials' sums and
    # the gold logits ([8, 128] f32, 4096 B) combined in the forward and
    # the recompute, the last two's adjoints once: 256 all-reduces. Weight
    # reads: position 0's two query heads read KV head 0 of 4, which its
    # own 32 of wk's / wv's 512 columns do not hold, so it reads both whole
    # at each use: the 15 other chunks ([4096, 32] bf16, 262,144 B) of
    # each, in the forward and the recompute of 32 blocks, whatever the rows
    x = 8 * 4096 * 4096 * 2
    tp_terms = {"all-gather": (193 * x, 193),
                "reduce-scatter": (193 * x // 16, 193),
                "all-to-all": (2 * x // 16, 2),
                "all-reduce": (256 * 4096, 256),
                "collective-permute": (0, 0),
                "weight-reads": (2 * 32 * 2 * 15 * 262144, 1920)}
    cfg = tconfigs.get("yi_6b")
    assert dryrun.tp_collectives(cfg, 8, 4096, 16, True) == tp_terms
    # the FSDP terms, on top, gather twice for each reduce-scatter
    fsdp_gathers = col["all-gather"]["count"] - 2 * 193
    fsdp_scatters = col["reduce-scatter"]["count"] - 2 * 193
    assert fsdp_gathers == fsdp_scatters * 2 > 0
    assert col["all-to-all"] == {"bytes": 2 * 2 * x // 16, "count": 2 * 2}
    assert "the layout's count, not XLA's" in col["source"]
    assert {"source"} <= set(mem) & set(cost) & set(col)

    fl = dryrun.run_one("yi_6b", "train_4k", "pod", fl=True,
                        out_dir=str(tmp_path))
    assert fl["status"] == "ok", fl.get("traceback")
    assert (tmp_path / "yi_6b__train_4k__pod__fl.json").exists()
    by = fl["memory"]["argument_bytes_by_name"]
    assert by["round_key"] == 8 and by["residuals"] > 0
    assert fl["memory"]["donated_argument_bytes"] == (by["params"]
                                                      + by["residuals"])
    assert fl["cost"]["calls"] == 4
    assert fl["cost"]["flops_total"] == pytest.approx(cost["flops_total"],
                                                      rel=1e-12)
    col = fl["collectives"]
    assert col["total_bytes"] == sum(col[op]["bytes"] for op in ops)
    assert col["participants"] == 2
    # a participant's data x model sub-mesh gathers the single pod's
    # parameters, its tensor-parallel collectives carry half the rows (4 a
    # device a call); the exchange adds one gather a leaf of a device's
    # block of every participant's streams
    single = rec["collectives"]["all-gather"]
    assert col["all-gather"]["bytes"] == single["bytes"] - 2 * 193 * x // 2 \
        + col["stream_exchange_bytes"] // col["blocks_per_participant"]
    n_leaves = len(dryrun.convert.reference_leaves(
        dryrun.tf.init_params(tconfigs.get("yi_6b"), device="meta")))
    assert col["all-gather"]["count"] == single["count"] + n_leaves
    assert col["stream_exchange_bytes"] == 8 * col["stream_entries"]
    assert col["upload_vs_dense"] == pytest.approx(0.020386, abs=5e-6)


def test_fl_on_the_single_mesh_fails_with_a_reason(tmp_path):
    """The single pod's federation axis is ``data``, which leaves no batch
    axis: the reference's rules raise there, and the record says so."""
    rec = dryrun.run_one("yi_6b", "train_4k", "single", fl=True,
                         out_dir=str(tmp_path))
    assert rec["status"] == "fail" and "IndexError" in rec["error"]


def test_roofline_csv_without_a_card_and_tables(tmp_path, monkeypatch,
                                                capsys):
    out = tmp_path / "experiments" / "dryrun_torch"
    dryrun.run_one("deepseek_moe_16b", "decode_32k", "single",
                   out_dir=str(out))
    dryrun.run_one("hubert_xlarge", "long_500k", "pod", out_dir=str(out))
    monkeypatch.chdir(tmp_path)
    assert bench_main(["--csv", "--only", "roofline"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in rows[1:]] == [
        "roofline/deepseek_moe_16b/decode_32k/single"]
    coll = json.loads((out / "deepseek_moe_16b__decode_32k__single.json")
                      .read_text())["collectives"]["total_bytes"]
    assert f"t_collective={coll / (256 * 50e9):.6f}s;bottleneck=memory" \
        in rows[1]
    assert experiments_tables.main(["--dir", str(out)]) == 0
    md = capsys.readouterr().out
    assert "built OK: **1**, structural skips: 1" in md
    assert "| deepseek_moe_16b | decode_32k |" in md


def test_dryrun_and_roofline_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.bench.paper."
            "roofline, repro_torch.bench.paper.experiments_tables\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m == "
            "'repro' or m.startswith(('jax.', 'repro.')))\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]


# ---------------------------------------------- the layout's collectives
def test_layout_collectives_hand_counted_on_a_toy_mesh():
    """data 2 x model 2, a train step of 2 calls over 8 rows of T 4 (2 rows
    a device a call), reduced Yi-6B (2 layers, d 256) in bf16: a
    column-parallel, a row-parallel (2 stacked layers each) and a
    replicated leaf, and ``launch/tp.py``'s collectives, counted by
    hand."""
    from repro_torch.configs.base import reduced
    from repro_torch.launch.mesh import LogicalMesh, logical_rules
    from repro_torch.models.sharding import P

    mesh = LogicalMesh((2, 2), ("data", "model"), device="meta")
    rules = logical_rules(mesh)
    bf16, f32 = torch.bfloat16, torch.float32
    layout = {"params": [
        ("blocks.mlp.wi_gate", (2, 8, 16), bf16, P(None, "data", "model")),
        ("blocks.mlp.wo", (2, 16, 8), bf16, P(None, "model", "data")),
        ("final_norm.scale", (8,), f32, P(None))]}
    shape = types.SimpleNamespace(kind="train", global_batch=8, seq_len=4)
    cfg = reduced(tconfigs.get("yi_6b"), dtype="bfloat16")
    assert (cfg.n_layers, cfg.d_model) == (2, 256)
    got = dryrun.layout_collectives(cfg, shape, mesh, rules, layout, calls=2)
    # each FSDP leaf: gathered over data to 2 x 8 x 8 bf16 (256 B), in the
    # forward and the backward of 2 calls, one a stacked layer; its
    # gradient's shard (128 B) reduce-scattered once a call and layer.
    # Tensor parallel, a call: the stream [2 rows, T 4, 256] bf16 (X = 4096
    # B) splits by sequence; each block all-gathers its two normed inputs
    # (X) and reduce-scatters its two row-parallel partials (X / 2) in the
    # forward and the recompute, and runs their adjoints once; the loss
    # gathers the final hidden (X; backward X / 2)
    x = 2 * 4 * 256 * 2
    assert got["all-gather"] == {"bytes": 2 * 2 * 2 * 256 + 2 * 13 * x,
                                 "count": 2 * 8 + 2 * 13}
    assert got["reduce-scatter"] == {
        "bytes": 2 * 2 * 128 + 2 * 13 * x // 2, "count": 2 * 4 + 2 * 13}
    # the norm's f32 gradient (32 B) all-reduced over data once a call;
    # the loss's one 4-token chunk: the max, the sums of exponentials and
    # the gold logit ([2, 4] f32, 32 B) combined in the forward and the
    # recompute, the two sums' gradients once
    assert got["all-reduce"] == {"bytes": 2 * 32 + 2 * 8 * 32,
                                 "count": 2 + 2 * 8}
    # the embedding (256 features, split over model) hands each position
    # its sequence slice (X / 2) by an all-to-all and its adjoint
    assert got["all-to-all"] == {"bytes": 2 * 2 * x // 2, "count": 2 * 2}
    assert got["collective-permute"] == {"bytes": 0, "count": 0}
    assert got["total_bytes"] == sum(got[op]["bytes"]
                                     for op in dryrun.COLLECTIVE_OPS)
    # prefill: the forward's gathers and the grid serve step's blocks
    # (launch/tp_serve.py) of one call, 4 rows of T 4 (X = 8192 B): no
    # loss. The serve terms: the last row ([4, 1, 256] bf16) handed from
    # position 1 to position 0, its logits ([4, 1, 512] bf16) all-gathered
    # whole; the cache (4 slots) is whole, so each position projects every
    # KV head from wk / wv read whole: position 0 reads the other chunk
    # ([256, 64] bf16) of both in each of 2 layers, and no K/V moves
    prefill = types.SimpleNamespace(kind="prefill", global_batch=8,
                                    seq_len=4)
    got = dryrun.layout_collectives(cfg, prefill, mesh, rules, layout,
                                    calls=1)
    x = 4 * 4 * 256 * 2
    assert got["all-gather"] == {"bytes": 2 * 256 + 4 * x + 4 * 512 * 2,
                                 "count": 9}
    assert got["reduce-scatter"] == {"bytes": 4 * x // 2, "count": 4}
    assert got["all-reduce"] == {"bytes": 0, "count": 0}
    assert got["all-to-all"] == {"bytes": x // 2, "count": 1}
    assert got["collective-permute"] == {"bytes": 4 * 256 * 2, "count": 1}
    assert got["weight-reads"] == {"bytes": 2 * 2 * 256 * 64 * 2, "count": 4}
    # decode, one call of 4 rows on a cache of 4 slots (whole): the FSDP
    # gathers as for the prefill; the embed
    # all-gather ([4, 1, 128] a position), q / k / v all-gathered from
    # each position's columns ([4, 1, 256 | 128 | 128] whole) and the
    # attention's and MLP's [4, 1, 256] partials all-reduced in each of 2
    # layers, the logits all-gathered; each position attends its own
    # heads over the whole cache, so no statistic moves
    decode = types.SimpleNamespace(kind="decode", global_batch=8, seq_len=4)
    got = dryrun.layout_collectives(cfg, decode, mesh, rules, layout,
                                    calls=1)
    row = 4 * 256 * 2
    assert got["all-gather"] == {
        "bytes": 2 * 256 + row + 2 * (row + 2 * row // 2) + 4 * 512 * 2,
        "count": 4 + 1 + 2 * 3 + 1}
    assert got["all-reduce"] == {"bytes": 2 * 2 * row, "count": 4}
    assert got["reduce-scatter"] == {"bytes": 0, "count": 0}
    assert got["weight-reads"] == {"bytes": 0, "count": 0}


def test_layout_collectives_hand_counted_folded_row_on_a_toy_mesh():
    """``long_500k``'s folded decode on the toy mesh above (data 2 x model
    2, the same three leaves): ``step_rules`` move the batch axis into
    ``kv_seq``, but ``param_specs`` still shard the weights over data and
    each data group's ``GridView`` gathers its weights, so the row counts
    the FSDP all-gathers an ordinary decode of the layout counts: each
    data-sharded leaf gathered to its model slice, 2 x 8 x 8 bf16 (256 B),
    once a stacked layer (2 each), 512 B in 4 calls; the replicated norm
    none. The traced terms of the folded grid decode (no parameter leaf)
    are the rest of the count, unchanged; every row whose batch is on an
    axis counts as before (the toy test above pins them by hand)."""
    from repro_torch.configs.base import reduced
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.models.sharding import P

    mesh = LogicalMesh((2, 2), ("data", "model"), device="meta")
    bf16, f32 = torch.bfloat16, torch.float32
    layout = {"params": [
        ("blocks.mlp.wi_gate", (2, 8, 16), bf16, P(None, "data", "model")),
        ("blocks.mlp.wo", (2, 16, 8), bf16, P(None, "model", "data")),
        ("final_norm.scale", (8,), f32, P(None))]}
    cfg = reduced(tconfigs.get("yi_6b"), dtype="bfloat16",
                  n_layers=2).long_context_variant()
    shape = specs.InputShape("long", 16, 1, "decode")
    rules = dryrun.step_rules(mesh, shape, None)
    assert rules["batch"] is None and rules["kv_seq"] == ("data", "model")
    assert dryrun.fold_groups(shape, rules, mesh.shape) == 2
    got = dryrun.layout_collectives(cfg, shape, mesh, rules, layout,
                                    calls=1)
    traced = dryrun.layout_collectives(cfg, shape, mesh, rules,
                                       {"params": []}, calls=1)
    assert got["all-gather"] == {
        "bytes": traced["all-gather"]["bytes"] + 2 * 256,
        "count": traced["all-gather"]["count"] + 4}
    for op in dryrun.COUNTED:
        if op != "all-gather":
            assert got[op] == traced[op]
    # the same FSDP gathers as a decode of 8 rows with its batch on data
    plain_shape = types.SimpleNamespace(kind="decode", global_batch=8,
                                        seq_len=16)
    plain_rules = dryrun.step_rules(mesh, plain_shape, None)
    assert plain_rules["batch"] == "data"
    plain = dryrun.layout_collectives(cfg, plain_shape, mesh, plain_rules,
                                      layout, calls=1)
    bare = dryrun.layout_collectives(cfg, plain_shape, mesh, plain_rules,
                                     {"params": []}, calls=1)
    assert plain["all-gather"] == {
        "bytes": bare["all-gather"]["bytes"] + 2 * 256,
        "count": bare["all-gather"]["count"] + 4}


def _counted_grid_step(cfg, m: int, B: int, T: int) -> dict:
    """One dense step of ``cfg`` over ``(data 1, model m)`` positions
    sharing the CPU, counted by ``dryrun.counting_tp``."""
    from repro_torch.launch import fsdp
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.models import transformer as tf

    cpu = torch.device("cpu")
    mesh = LogicalMesh((1, m), ("data", "model"), "cpu")
    lm = fsdp.shard(tf.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"),
                    mesh, groups=[((cpu,) * m, range(0, 1))])
    rs = np.random.RandomState(0)
    batch = {"labels": torch.from_numpy(
        rs.randint(0, cfg.vocab, (B, T)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rs.randn(B, T, cfg.d_model).astype(np.float32))
    else:
        batch["tokens"] = torch.from_numpy(
            rs.randint(0, cfg.vocab, (B, T)).astype(np.int32))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rs.randn(
            B, cfg.n_image_tokens, cfg.d_model).astype(np.float32))
    with dryrun.counting_tp() as counted:
        fsdp.step_gradients(lm, cfg, batch)
    return counted, mesh


def _params_layout(cfg, mesh) -> tuple:
    from repro_torch import convert
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import logical_rules
    from repro_torch.models import transformer as tf

    rules = logical_rules(mesh)
    model = tf.init_params(cfg, device="meta")
    named = dict(model.named_parameters())
    leaves = convert.reference_leaves(model)
    specs = shd.param_specs({lf.path: lf.shape for lf in leaves}, rules,
                            mesh)
    return rules, {"params": [(lf.path, lf.shape, named[lf.names[0]].dtype,
                               specs[lf.path]) for lf in leaves]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("m,T", [(2, 32), (4, 30), (3, 32), (2, 384)],
                         ids=["split-2", "whole-4", "whole-3", "split-2-T384"])
def test_layout_collectives_equal_a_counted_grid_step(arch, m, T):
    """``layout_collectives`` on a ``(data 1, model m)`` toy grid (no FSDP
    term: one data position), which traces one row with no layer and one
    period of the layers (a layer, a super-block, xLSTM's sLSTM and
    mLSTM) on the meta device and carries them to 4 layers, 2 rows and, at
    T 384, from T 128 and 256, equals the bytes and calls position 0's
    collectives and weight reads across positions return in one counted
    step of the reduced model on the CPU, for a split stream and a whole
    one."""
    from repro_torch.configs.base import reduced

    cfg = reduced(tconfigs.get(arch), dtype="float32", n_layers=4)
    B = 2
    counted, mesh = _counted_grid_step(cfg, m, B, T)
    rules, layout = _params_layout(cfg, mesh)
    shape = types.SimpleNamespace(kind="train", global_batch=B, seq_len=T)
    want = dryrun.layout_collectives(cfg, shape, mesh, rules, layout,
                                     calls=1)
    assert counted == {op: want[op] for op in dryrun.COUNTED}
    if cfg.family == "moe":
        assert counted["all-to-all" if T % m == 0 else "all-gather"][
            "bytes"] >= 3 * cfg.n_layers * B * T * cfg.moe.top_k \
            * cfg.d_model * 4


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("m,S", [(2, 1040), (4, 1040), (2, 40)],
                         ids=["split-2", "split-4", "whole-2"])
def test_layout_collectives_equal_a_counted_grid_serve_step(arch, kind, m,
                                                            S):
    """The serve rows of the dense and MoE families: ``layout_collectives``
    on a ``(data 1, model m)`` toy grid, which traces the grid serve step
    (``launch/tp_serve.py``) on the meta device at one row with no layer
    and one, carried to 3 layers and 2 rows, equals what position 0's
    collectives return in one counted prefill of ``S`` tokens into a cache
    of ``S`` slots, or one counted decode step on such a cache, of the
    reduced model on the CPU: a cache split over ``model`` (1,040 slots;
    Yi-6B's K/V by the all-to-all at model 2, narrowed locally at 4) and a
    whole one."""
    from repro_torch.configs.base import reduced
    from repro_torch.launch import fsdp, serve, specs
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.models import transformer as tf

    cfg = reduced(tconfigs.get(arch), dtype="float32", n_layers=3)
    B = 2
    cpu = torch.device("cpu")
    mesh = LogicalMesh((1, m), ("data", "model"), "cpu")
    lm = fsdp.shard(tf.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"),
                    mesh, groups=[((cpu,) * m, range(0, 1))])
    rs = np.random.RandomState(1)
    if kind == "prefill":
        tokens = torch.from_numpy(rs.randint(0, cfg.vocab, (B, S))
                                  .astype(np.int32))
        with dryrun.counting_tp() as counted:
            serve.make_prefill_step(cfg, S)(lm, tokens)
    else:
        _, state = serve.make_prefill_step(cfg, S)(lm, torch.from_numpy(
            rs.randint(0, cfg.vocab, (B, 8)).astype(np.int32)))
        tok = torch.from_numpy(rs.randint(0, cfg.vocab, (B, 1))
                               .astype(np.int32))
        with dryrun.counting_tp() as counted:
            serve.make_decode_step(cfg)(lm, tok, state)
        assert state.split == (S >= specs.KV_SPLIT_SLOTS)
    rules, layout = _params_layout(cfg, mesh)
    shape = types.SimpleNamespace(kind=kind, global_batch=B, seq_len=S)
    assert dryrun.serves_on_grid(cfg, shape, rules)
    want = dryrun.layout_collectives(cfg, shape, mesh, rules, layout,
                                     calls=1)
    assert counted == {op: want[op] for op in dryrun.COUNTED}
    if kind == "decode" and S >= specs.KV_SPLIT_SLOTS:
        # per layer: the max and the sums all-reduced, the P.V partials
        # reduce-scattered
        assert counted["reduce-scatter"]["count"] == cfg.n_layers


FAMILY_SERVE = [(a, k) for a in ("llama32_vision_90b", "zamba2_7b",
                                 "xlstm_125m") for k in ("prefill", "decode")
                ] + [("hubert_xlarge", "prefill")]


@pytest.mark.parametrize("arch,kind", FAMILY_SERVE,
                         ids=[f"{a}-{k}" for a, k in FAMILY_SERVE])
@pytest.mark.parametrize("m,S", [(2, 1024), (4, 1024), (2, 40)],
                         ids=["split-2", "split-4", "whole-2"])
def test_layout_collectives_equal_a_counted_grid_serve_step_of_a_family(
        arch, kind, m, S):
    """The serve rows of the VLM (1,024 image tokens: its cross K/V split
    over ``model``), hybrid, xLSTM and audio families, as the dense and
    MoE rows above: ``layout_collectives`` on a ``(data 1, model m)`` toy
    grid, which traces the grid serve step at one row with no period of
    the layer pattern and one (a VLM or hybrid super-block, xLSTM's two
    cells), carried to two periods (three hybrid super-blocks, three audio
    layers) and 2 rows, and xLSTM's prefill at T 128 and 256 carried to T
    1,024, equals what position 0's collectives return in one counted
    prefill or decode step of the reduced model on the CPU."""
    from repro_torch.configs.base import reduced
    from repro_torch.launch import fsdp, serve
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.models import transformer as tf

    over = {"n_image_tokens": 1024} if arch.startswith("llama32") else {}
    layers = {"zamba2_7b": 3, "hubert_xlarge": 3}.get(arch, 4)
    cfg = reduced(tconfigs.get(arch), dtype="float32", n_layers=layers,
                  **over)
    B = 2
    cpu = torch.device("cpu")
    mesh = LogicalMesh((1, m), ("data", "model"), "cpu")
    lm = fsdp.shard(tf.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"),
                    mesh, groups=[((cpu,) * m, range(0, 1))])
    rs = np.random.RandomState(2)
    img = (torch.from_numpy(rs.randn(B, cfg.n_image_tokens, cfg.d_model)
                            .astype(np.float32))
           if cfg.family == "vlm" else None)

    def prompt(t):
        if cfg.family == "audio":
            return torch.from_numpy(rs.randn(B, t, cfg.d_model)
                                    .astype(np.float32))
        return torch.from_numpy(rs.randint(0, cfg.vocab, (B, t))
                                .astype(np.int32))

    if kind == "prefill":
        tokens = prompt(S)
        with dryrun.counting_tp() as counted:
            serve.make_prefill_step(cfg, S)(lm, tokens, img)
    else:
        _, state = serve.make_prefill_step(cfg, S)(lm, prompt(8), img)
        tok = torch.from_numpy(rs.randint(0, cfg.vocab, (B, 1))
                               .astype(np.int32))
        with dryrun.counting_tp() as counted:
            serve.make_decode_step(cfg)(lm, tok, state)
    rules, layout = _params_layout(cfg, mesh)
    shape = types.SimpleNamespace(kind=kind, global_batch=B, seq_len=S)
    assert dryrun.serves_on_grid(cfg, shape, rules)
    want = dryrun.layout_collectives(cfg, shape, mesh, rules, layout,
                                     calls=1)
    assert counted == {op: want[op] for op in dryrun.COUNTED}
    if cfg.xlstm and kind == "prefill" and S == 1024:
        assert dryrun._lengths(S, m) == (128, 256)


FOLDED_SERVE = ["yi_6b", "zamba2_7b", "llama32_vision_90b"]


@pytest.mark.parametrize("arch", FOLDED_SERVE)
def test_folded_decode_count_equals_a_counted_cpu_grid_decode(arch):
    """``long_500k``'s decode row: ``layout_collectives`` under the
    rewritten rules (``step_rules``: one row, ``kv_seq`` over data and
    model) on a (2, 2) toy grid, which traces the folded grid decode on a
    meta grid of every cell at no period of the layer pattern and one,
    carried to the depth, equals what ``counting_tp((2, 2))`` returns over
    one decode step of the reduced long-context model, one row on a CPU
    grid of 2 data groups x 2 positions: the statistics' all-reduces and
    the P·V reduce-scatter over all four cells once each, a group's own
    collectives once (group 0's); the VLM with 1,024 image tokens. The
    layout adds the weights' FSDP all-gathers over data on top, one a
    data-sharded leaf and stacked layer."""
    import dataclasses

    from repro_torch.configs.base import reduced
    from repro_torch.launch import fsdp, serve
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import P

    over = {"n_image_tokens": 1024} if arch.startswith("llama32") else {}
    layers = {"zamba2_7b": 3}.get(arch, 4)
    cfg = reduced(tconfigs.get(arch), dtype="float32", n_layers=layers,
                  **over).long_context_variant()
    if cfg.window is not None:
        cfg = dataclasses.replace(cfg, window=16)
    S, cpu = 1040, torch.device("cpu")
    mesh = LogicalMesh((2, 2), ("data", "model"), "cpu")
    lm = fsdp.shard(tf.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"),
                    mesh, groups=[((cpu,) * 2, range(g, g + 1))
                                  for g in range(2)])
    rs = np.random.RandomState(3)
    img = (torch.from_numpy(rs.randn(1, cfg.n_image_tokens, cfg.d_model)
                            .astype(np.float32))
           if cfg.family == "vlm" else None)
    _, state = serve.make_prefill_step(cfg, S)(lm, torch.from_numpy(
        rs.randint(0, cfg.vocab, (1, 8)).astype(np.int32)), img)
    assert state.folded and state.split
    tok = torch.from_numpy(rs.randint(0, cfg.vocab, (1, 1)).astype(np.int32))
    with dryrun.counting_tp((2, 2)) as counted:
        serve.make_decode_step(cfg)(lm, tok, state)
    shape = specs.InputShape("long", S, 1, "decode")
    rules = dryrun.step_rules(mesh, shape, None)
    _, layout = _params_layout(cfg, mesh)
    assert dryrun.serves_on_grid(cfg, shape, rules)
    assert dryrun.fold_groups(shape, rules, mesh.shape) == 2
    # the traced terms alone (no parameter leaf): the weights' FSDP
    # gathers, which each group's GridView makes outside ``launch/tp.py``,
    # are counted from the layout's specs and added on top, each leaf
    # sharded over data gathered once to its model slice
    want = dryrun.layout_collectives(cfg, shape, mesh, rules,
                                     {"params": []}, calls=1)
    assert counted == {op: want[op] for op in dryrun.COUNTED}
    full = dryrun.layout_collectives(cfg, shape, mesh, rules, layout,
                                     calls=1)
    gathers = {"bytes": 0, "count": 0}
    for path, shp, dt, spec in layout["params"]:
        entries = [e if isinstance(e, tuple) else (e,) for e in spec]
        if any("data" in e for e in entries):
            model_slice = P(*["model" if "model" in e else None
                              for e in entries])
            rule = shd.leaf_rule(path, shp)
            gathers["bytes"] += dryrun.shard_bytes(shp, dt, model_slice,
                                                   mesh.shape)
            gathers["count"] += math.prod(shp[:len(shp) - len(rule)])
    assert gathers["count"] > 0
    assert full["all-gather"] == {
        k: want["all-gather"][k] + gathers[k] for k in gathers}
    for op in dryrun.COUNTED:
        if op != "all-gather":
            assert full[op] == want[op]
    # one P.V reduce-scatter an attention call (the VLM's cross reads too)
    calls = (tf.n_super(cfg) if cfg.family == "hybrid" else cfg.n_layers)
    assert counted["reduce-scatter"]["count"] == calls


# ----------------------------------------------- chip_smoke's train FLOPs
def _train_flops():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.train_flops


def _meta_train_count(cfg, B: int, T: int) -> tuple[float, int]:
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf

    model = tf.init_params(cfg, device="meta")
    batch = {k: torch.empty((B, T), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    total, _ = dryrun._count(lambda: train.value_and_grad(model, cfg, batch))
    return total, tf.param_count(model)


@pytest.mark.parametrize("layers,d,T,B", [(2, 256, 2048, 2),
                                          (3, 256, 4096, 1),
                                          (2, 512, 1024, 2),
                                          (2, 256, 512, 3)])
def test_train_flops_match_the_meta_count_at_reduced_widths(layers, d, T, B):
    """Below and above ``attention.CHUNK_Q``: one query chunk, and chunks
    under checkpoints of their own."""
    from repro_torch.configs.base import reduced

    cfg = reduced(tconfigs.get("yi_6b"), n_layers=layers, d_model=d,
                  n_heads=4, n_kv_heads=2, d_ff=4 * d, vocab=1000)
    count, n = _meta_train_count(cfg, B, T)
    got = _train_flops()(cfg, n, B, T)
    assert got["total"] == pytest.approx(count, rel=1e-2)


def test_train_flops_of_yi6b_step_equal_the_dry_run_count():
    """Yi-6B at B 4 x T 4096, two microbatches of 2 rows as ``[train]``
    runs it: 8.7109e14 (the dry run's count), within 1%."""
    cfg = tconfigs.get("yi_6b")
    count, n = _meta_train_count(cfg, 2, 4096)
    assert 2 * count == pytest.approx(8.7109e14, rel=1e-4)
    got = _train_flops()(cfg, n, 4, 4096)
    assert got["total"] == pytest.approx(2 * count, rel=1e-2)
