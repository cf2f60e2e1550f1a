"""Port parity: ``repro_torch.lint`` against ``repro.lint``.

* RPL001, RPL003 and RPL007 carry over: on the reference's good and bad
  fixtures (copied here, so an edit to ``tests/test_lint.py`` cannot move
  them) and on every file of the port, both gates give the same findings
  (id, line, column); RPL002 does so with each fixture under its own
  package's bench path;
* the port's meanings of RPL004 (accumulating scatters and
  ``torch.distributed`` reductions in decode modules), RPL005 (a CUDA
  wrapper's ``kernels/ref.py`` twin, launches under ``build.on_device``)
  and RPL006 (host syncs in decode modules): a good/bad pair each, every
  bad one failing ``--gate``;
* the suppression comments, one comment serving both gates;
* the ``repro.lint/v1`` document, each package's validated by the other;
* ``import repro_torch.lint`` loads neither torch, jax nor ``repro``, and
  the port's gate is clean over ``src/repro_torch``, the port's tests and
  ``chip_smoke.py``.

Bad fixtures stay strings (written under ``tmp_path`` where a check needs
a file): ``tests/test_lint.py`` lints every committed file of ``tests``.
"""
import glob
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro import lint as jlint  # noqa: E402
from repro.lint import report as jreport  # noqa: E402
from repro_torch import lint  # noqa: E402
from repro_torch.lint import report  # noqa: E402
from repro_torch.lint.__main__ import main  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------------------
# the reference's fixtures (tests/test_lint.py), copied
# ------------------------------------------------------------------------
REF_GOOD = {
    "RPL001": (
        "src/repro/sim/clock.py",
        "import time\n"
        "import zlib\n"
        "\n"
        "\n"
        "def digest(name):\n"
        "    return zlib.crc32(name.encode())\n"
        "\n"
        "\n"
        "def wall(t0):\n"
        "    return time.perf_counter() - t0\n"
        "\n"
        "\n"
        "def stable(xs):\n"
        "    return sorted(set(xs))\n",
    ),
    "RPL002": (
        "src/repro/bench/good_bench.py",
        "from repro.bench.timing import entry, measure\n"
        "\n"
        "\n"
        "def entries(quick=False):\n"
        "    us = measure(lambda: None, reps=3)\n"
        "    return [entry('agg/noop', us, reps=3)]\n",
    ),
    "RPL003": (
        "src/repro/core/wire.py",
        "from repro.core.codecs import reject_codec_with_masks\n"
        "\n"
        "\n"
        "def encode(updates, codec='f32', k_mask=0):\n"
        "    reject_codec_with_masks(codec, k_mask)\n"
        "    return updates\n",
    ),
    "RPL007": (
        "src/repro/sim/sidecar.py",
        "import json\n"
        "import os\n"
        "\n"
        "\n"
        "def write(path, obj):\n"
        "    tmp = path + '.tmp'\n"
        "    with open(tmp, 'w') as f:\n"
        "        json.dump(obj, f)\n"
        "    os.replace(tmp, path)\n",
    ),
}

REF_BAD = {
    "RPL001": (
        "src/repro/sim/clock.py",
        "import random\n"
        "import time\n"
        "\n"
        "\n"
        "def seed_for(name):\n"
        "    return hash(name) % 100\n"
        "\n"
        "\n"
        "def stamp():\n"
        "    return time.time()\n"
        "\n"
        "\n"
        "def pick(xs):\n"
        "    return random.choice(xs)\n"
        "\n"
        "\n"
        "def order(xs):\n"
        "    return list(set(xs))\n",
    ),
    "RPL002": (
        "src/repro/bench/bad_bench.py",
        "from repro.bench.timing import entry, time_us\n"
        "\n"
        "\n"
        "def entries(quick=False):\n"
        "    us = time_us(lambda: None, reps=2)\n"
        "    return [entry('agg/noop', us, reps=2)]\n",
    ),
    "RPL003": (
        "src/repro/core/wire.py",
        "def encode(updates, codec='f32', k_mask=0):\n"
        "    return updates, codec, k_mask\n",
    ),
    "RPL007": (
        "src/repro/sim/sidecar.py",
        "import json\n"
        "\n"
        "\n"
        "def write(path, obj):\n"
        "    with open(path, 'w') as f:\n"
        "        json.dump(obj, f)\n",
    ),
}

SHARED = sorted(REF_GOOD)        # the rules that carry over


def _port_path(path: str) -> str:
    return path.replace("src/repro/", "src/repro_torch/")


def _key(findings) -> list:
    return [(f.check, f.line, f.col, f.suppressed) for f in findings]


# ------------------------------------------------------------------------
# the port's own fixtures: RPL004, RPL005, RPL006
# ------------------------------------------------------------------------
REF_TWINS = (
    "def goodop_ref(x):\n"
    "    return x\n"
    "\n"
    "\n"
    "def pair_mask_stream_ref(x):\n"
    "    return x\n"
    "\n"
    "\n"
    "def mask_prng_ref(x):\n"
    "    return x\n"
)

GOOD = {
    "RPL004": (
        "src/repro_torch/core/streams.py",
        "import torch\n"
        "\n"
        "from repro_torch.kernels import ops\n"
        "\n"
        "\n"
        "def decode(idx, vals, size, parts):\n"
        "    dense = ops.stream_scatter_add(idx, vals, size=size)\n"
        "    out = torch.zeros(size)\n"
        "    out.index_put_((idx,), vals)\n"
        "    out.index_put_((idx,), vals, accumulate=False)\n"
        "    return dense + out, torch.cat(parts, -1)\n",
    ),
    "RPL005": (
        "kernels/goodop.py",
        "import torch\n"
        "\n"
        "from repro_torch.kernels import build\n"
        "\n"
        "\n"
        "def goodop_cuda(x):\n"
        "    fn = build.kernel('goodop')\n"
        "    scratch = build.kernel('goodop_bytes')(x.numel())\n"
        "    with build.on_device(x.device):\n"
        "        stream = torch.cuda.current_stream(x.device).cuda_stream\n"
        "        build.check(fn(x.data_ptr(), scratch, stream), 'goodop')\n"
        "    return x\n"
        "\n"
        "\n"
        "def pair_mask_streams_cuda(x):\n"
        "    return x\n"
        "\n"
        "\n"
        "def mask_prng_apply_cuda(x):\n"
        "    return x\n"
        "\n"
        "\n"
        "def weird_cuda(x):  # repro-lint: twin=goodop_ref\n"
        "    return x\n",
    ),
    "RPL006": (
        "src/repro_torch/kernels/stream_decode.py",
        "import torch\n"
        "\n"
        "\n"
        "def decode(x, k, n_groups):\n"
        "    k = int(min(k, x.shape[-1]))\n"
        "    g = max(1, int(n_groups), int(x.numel()))\n"
        "    rows = int(x.shape[0])\n"
        "    return torch.where(x > 0, x, 0.0)[:k], g, rows\n",
    ),
}

BAD = {
    "RPL004": (
        "src/repro_torch/core/blocked.py",
        "import torch\n"
        "import torch.distributed as dist\n"
        "\n"
        "\n"
        "def decode(idx, vals, size, parts):\n"
        "    out = torch.zeros(size)\n"
        "    out.index_add_(0, idx, vals)\n"
        "    out = out.scatter_add(0, idx, vals)\n"
        "    out.index_put_((idx,), vals, accumulate=True)\n"
        "    torch.index_put(out, (idx,), vals, True)\n"
        "    out = out.scatter_reduce(0, idx, vals, 'sum')\n"
        "    dist.reduce_scatter_tensor(out, parts)\n"
        "    dist.all_reduce(out)\n"
        "    return out\n",
    ),
    "RPL005": (
        "kernels/badop.py",
        "import torch\n"
        "\n"
        "from repro_torch.kernels import build\n"
        "\n"
        "\n"
        "def badop_cuda(x):\n"
        "    fn = build.kernel('badop')\n"
        "    stream = torch.cuda.current_stream(x.device).cuda_stream\n"
        "    build.check(fn(x.data_ptr(), stream), 'badop')\n"
        "    return x\n",
    ),
    "RPL006": (
        "src/repro_torch/kernels/stream_decode.py",
        "import torch\n"
        "\n"
        "\n"
        "def decode(x, seeds):\n"
        "    total = x.sum().item()\n"
        "    keys = seeds.tolist()\n"
        "    host = x.cpu()\n"
        "    if bool(torch.any(x < 0)):\n"
        "        total += float(x[0])\n"
        "    return total, keys, host.numpy()\n",
    ),
}

PORT_IDS = sorted(GOOD)


def _write(tmp_path, rel_path, source):
    path = tmp_path / rel_path
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    if rel_path.startswith("kernels/"):
        ref = path.parent / "ref.py"
        if not ref.exists():
            ref.write_text(REF_TWINS)
    return path


# ------------------------------------------------- the rules that carry over
@pytest.mark.parametrize("kind", ["good", "bad"])
@pytest.mark.parametrize("check_id", SHARED)
def test_shared_rule_findings_equal_the_reference(check_id, kind):
    path, source = (REF_GOOD if kind == "good" else REF_BAD)[check_id]
    want = jlint.lint_source(source, path=path, select={check_id})
    got = lint.lint_source(source, path=_port_path(path), select={check_id})
    assert _key(got) == _key(want)
    assert bool(got) == (kind == "bad")


@pytest.mark.parametrize("check_id", SHARED)
def test_shared_rule_bad_fixture_fails_the_gate(check_id, tmp_path, capsys):
    path, source = REF_BAD[check_id]
    _write(tmp_path, _port_path(path), source)
    assert main([str(tmp_path), "--gate", "--select", check_id]) == 1
    capsys.readouterr()


def test_rpl002_scopes_itself_to_the_port_bench():
    _, source = REF_BAD["RPL002"]
    assert lint.lint_source(source, path="src/repro/bench/bad_bench.py") == []
    assert lint.lint_source(
        source, path="src/repro_torch/bench/timing.py") == []
    port_suites = sorted(glob.glob(os.path.join(
        ROOT, "src", "repro_torch", "bench", "*_bench.py")))
    assert len(port_suites) == 4
    for path in port_suites:       # the committed suites time through measure
        assert lint.lint_file(path, select={"RPL002"}) == [], path


def test_shared_rules_agree_on_every_port_file():
    paths = sorted(lint.iter_python_files(
        [os.path.join(ROOT, "src", "repro_torch"),
         os.path.join(ROOT, "chip_smoke.py")]))
    assert len(paths) > 100
    select = {"RPL001", "RPL003", "RPL007"}
    for path in paths:
        got = lint.lint_file(path, select=select)
        want = jlint.lint_file(path, select=select)
        assert _key(got) == _key(want), path


# ---------------------------------------------- the port's own meanings
@pytest.mark.parametrize("check_id", PORT_IDS)
def test_port_bad_fixture_flags_exactly_this_check(check_id, tmp_path):
    rel_path, source = BAD[check_id]
    path = _write(tmp_path, rel_path, source)
    findings = lint.lint_file(str(path), select={check_id})
    assert findings, f"{check_id} bad fixture produced no findings"
    assert {f.check for f in findings} == {check_id}
    assert all(not f.suppressed for f in findings)


@pytest.mark.parametrize("check_id", PORT_IDS)
def test_port_good_fixture_is_clean(check_id, tmp_path):
    rel_path, source = GOOD[check_id]
    path = _write(tmp_path, rel_path, source)
    assert lint.lint_file(str(path), select={check_id}) == []


@pytest.mark.parametrize("check_id", PORT_IDS)
def test_port_gate_exits_nonzero_on_bad_fixture(check_id, tmp_path, capsys):
    rel_path, source = BAD[check_id]
    _write(tmp_path, rel_path, source)
    assert main([str(tmp_path), "--gate", "--select", check_id]) == 1
    assert main([str(tmp_path), "--gate", "--ignore", check_id]) == 0
    capsys.readouterr()


def test_rpl004_flags_every_unordered_fold():
    path, source = BAD["RPL004"]
    names = [f.message.split("(")[0] for f in
             lint.lint_source(source, path=path, select={"RPL004"})]
    assert names == ["index_add_", "scatter_add", "index_put_", "index_put",
                     "scatter_reduce", "reduce_scatter_tensor", "all_reduce"]
    # outside the decode modules it says nothing
    assert lint.lint_source(source, path="src/repro_torch/core/fedavg.py",
                            select={"RPL004"}) == []


def test_rpl004_reference_fixture_still_flags():
    source = ("import jax\n\n\ndef combine(parts):\n"
              "    return jax.lax.psum(parts, 'clients')\n")
    findings = lint.lint_source(source, path="src/repro_torch/core/streams.py")
    assert [f.check for f in findings] == ["RPL004"]


def test_rpl005_missing_twin_and_unguarded_launch(tmp_path):
    path, source = BAD["RPL005"]
    findings = lint.lint_file(str(_write(tmp_path, path, source)),
                              select={"RPL005"})
    messages = [f.message for f in findings]
    assert len(messages) == 2
    assert any("outside 'with build.on_device" in m for m in messages)
    assert any("no plain twin" in m and "badop_ref" in m for m in messages)
    # a wrapper with no ref.py beside it
    lone = tmp_path / "lone" / "kernels" / "lone.py"
    lone.parent.mkdir(parents=True)
    lone.write_text("def lone_cuda(x):\n    return x\n")
    assert "no kernels/ref.py sibling" in lint.lint_file(
        str(lone), select={"RPL005"})[0].message


def test_rpl005_real_kernel_modules_hold_the_contract():
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    wrappers = 0
    for path in sorted(glob.glob(os.path.join(kdir, "*.py"))):
        assert lint.lint_file(path, select={"RPL005"}) == [], path
        with open(path) as f:
            wrappers += f.read().count("_cuda(")
    assert wrappers >= 10


def test_rpl005_catches_a_launch_moved_off_on_device():
    path = os.path.join(ROOT, "src", "repro_torch", "kernels",
                        "stream_decode.py")
    with open(path) as f:
        text = f.read()
    guarded = ("    with build.on_device(indices.device):\n"
               "        stream = torch.cuda.current_stream(indices.device)"
               ".cuda_stream\n"
               "        rc = fn(")
    assert guarded in text, "stream_decode.py's launch moved; update this test"
    bad = text.replace(guarded, (
        "    if True:\n"
        "        stream = torch.cuda.current_stream(indices.device)"
        ".cuda_stream\n"
        "        rc = fn("))
    findings = lint.lint_source(bad, path=path, select={"RPL005"})
    assert [f.check for f in findings] == ["RPL005"]
    assert "stream_scatter_add_cuda() launches a kernel outside" in \
        findings[0].message


def test_rpl006_flags_each_host_sync():
    path, source = BAD["RPL006"]
    findings = lint.lint_source(source, path=path, select={"RPL006"})
    assert [f.line for f in findings] == [5, 6, 7, 8, 9, 10]
    # outside the decode modules, and in module-level code, it says nothing
    assert lint.lint_source(source, path="src/repro_torch/core/fedavg.py",
                            select={"RPL006"}) == []
    assert lint.lint_source("import torch\nN = torch.ones(2).sum().item()\n",
                            path="src/repro_torch/core/streams.py",
                            select={"RPL006"}) == []


def test_rpl006_and_rpl004_suppressions_in_streams_are_the_reviewed_ones():
    path = os.path.join(ROOT, "src", "repro_torch", "core", "streams.py")
    findings = lint.lint_file(path)
    assert [(f.check, f.suppressed) for f in findings] == [
        ("RPL006", True), ("RPL006", True), ("RPL004", True)]


def test_list_checks_names_every_rule_and_the_rpl006_decision(capsys):
    assert main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for check_id in ("RPL001", "RPL002", "RPL003", "RPL004", "RPL005",
                     "RPL006", "RPL007"):
        assert check_id in out
    assert "no @jit" in out
    assert sorted(lint.CHECKS) == sorted(jlint.CHECKS)


# ------------------------------------------------------------ suppressions
@pytest.mark.parametrize("source,want", [
    ("import time\n\nT0 = time.time()  # repro-lint: disable=RPL001\n",
     [True]),
    ("import time\n\n# repro-lint: disable-next=RPL001\nT0 = time.time()\n",
     [True]),
    ("# repro-lint: disable-file=RPL001\nimport time\n\nT0 = time.time()\n"
     "T1 = time.time()\n", [True, True]),
    ("import time\n\nT0 = time.time()  # repro-lint: disable=RPL002\n",
     [False]),
])
def test_suppression_comment_serves_both_gates(source, want):
    got = lint.lint_source(source, path="src/repro_torch/x.py")
    ref = jlint.lint_source(source, path="src/repro/x.py")
    assert [f.suppressed for f in got] == want
    assert _key(got) == _key(ref)


def test_the_committed_suppression_serves_both_gates():
    path = os.path.join(ROOT, "src", "repro_torch", "bench", "schema.py")
    got = lint.lint_file(path, select={"RPL001"})
    assert [(f.line, f.suppressed) for f in got] == [(106, True)]
    assert _key(got) == _key(jlint.lint_file(path, select={"RPL001"}))


def test_suppressed_findings_do_not_fail_the_gate(tmp_path, capsys):
    path = tmp_path / "x.py"
    path.write_text(
        "import time\n\nT0 = time.time()  # repro-lint: disable=RPL001\n")
    assert main([str(path), "--gate"]) == 0
    assert main([str(path), "--gate", "--show-suppressed"]) == 0
    assert "[suppressed]" in capsys.readouterr().out


# ------------------------------------------------------------- JSON schema
def test_documents_cross_validate(tmp_path, capsys):
    path, source = REF_BAD["RPL001"]
    port_doc = report.make_doc(
        lint.lint_source(source, path=_port_path(path)), 1, ["src"])
    ref_doc = jreport.make_doc(jlint.lint_source(source, path=path), 1,
                               ["src"])
    for doc in (port_doc, ref_doc):
        doc = json.loads(json.dumps(doc))
        assert report.validate_doc(doc) == []
        assert jreport.validate_doc(doc) == []
    assert port_doc["schema"] == ref_doc["schema"] == lint.SCHEMA_VERSION
    assert port_doc["counts"] == ref_doc["counts"] == {"RPL001": 4}
    # malformed documents fail both validators
    bad = dict(port_doc, counts={"RPL001": 7})
    assert report.validate_doc(bad) and jreport.validate_doc(bad)
    # the CLI's document
    src_file = tmp_path / "x.py"
    src_file.write_text("import time\n\nT0 = time.time()\n")
    out = tmp_path / "lint.json"
    assert main([str(src_file), "--format", "json", "--out", str(out)]) == 0
    capsys.readouterr()
    doc = json.loads(out.read_text())
    assert jreport.validate_doc(doc) == [] == report.validate_doc(doc)
    assert doc["counts"] == {"RPL001": 1}


# ------------------------------------------------------------ CLI behavior
def test_parse_error_unknown_id_and_vacuous_gate(tmp_path, capsys):
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert [f.check for f in lint.lint_file(str(broken))] == ["RPL000"]
    assert main([str(broken), "--gate"]) == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main([str(empty), "--gate"]) == 1
    assert main(["--select", "RPL999", str(empty)]) == 2
    capsys.readouterr()


def test_import_loads_neither_torch_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.lint\n"
            "import repro_torch.lint.__main__\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro', 'numpy'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]


def test_port_gate_is_clean_over_the_port(monkeypatch, capsys):
    tests = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    paths = [os.path.join(ROOT, "src", "repro_torch"), *tests,
             os.path.join(ROOT, "chip_smoke.py")]
    assert main([*paths, "--gate"]) == 0
    # the default paths, from the root of the checkout
    monkeypatch.chdir(ROOT)
    assert main(["--gate"]) == 0
    err = capsys.readouterr().err
    assert "gate OK" in err


def test_cli_module_runs(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    path, source = BAD["RPL006"]
    _write(tmp_path, path, source)
    p = subprocess.run([sys.executable, "-m", "repro_torch.lint",
                        str(tmp_path), "--gate"], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 1
    assert "RPL006" in p.stdout and "gate FAILED" in p.stderr
