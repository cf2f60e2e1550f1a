"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names; the reference and the frozen copies import nothing
of the program."""
import ast
import subprocess
import sys

import pytest

from fedbench.harness import manifest

PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}, {bench!r}]
import run
run._environment()
from fedbench.harness import manifest
cell = manifest.cell({cell!r})
run._driver(cell["traffic"])
import fedbench.calibrate
for m in cell["per_layer"]:
    manifest.reader(m["name"])
import repro_torch.core.fedavg, repro_torch.models.paper_models
import repro_torch.sim
print(",".join(run.banned_modules()))
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.manifest()["workloads"]])
def test_a_cells_import_path_loads_no_jax(cell):
    code = PROBE.format(root=str(manifest.ROOT),
                        src=str(manifest.ROOT / "src"),
                        bench=str(manifest.BENCH), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout.split("\n")
    assert out[0] == ""
    tops = set(out[1].split(","))
    assert "repro_torch" in tops and not tops & {"jax", "jaxlib", "flax",
                                                 "repro"}


def test_the_guard_compares_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    before = run.banned_modules()
    monkeypatch.setitem(sys.modules, "repro", object())
    assert run.banned_modules() == sorted(set(before) | {"repro"})


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("folder", ["reference", "frozen"])
def test_the_yardstick_imports_nothing_of_the_program(folder):
    for path in sorted((manifest.BENCH / folder).glob("*.py")):
        tops = set(_imports(path))
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, \
            path.name
