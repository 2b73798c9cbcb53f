"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; module names are compared by
their whole top-level name, since `seesaw_tpu_torch` begins with
`seesaw_tpu`."""
from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from loadbench.harness import runner
from loadbench.harness.cell import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "seesaw_tpu"}
REFERENCE = [BENCH_DIR / "harness" / "reference.py", BENCH_DIR / "harness" / "point.py",
             *sorted((BENCH_DIR / "checks").glob("*.py"))]


def _top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_in_sources(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & (FORBIDDEN | {"seesaw_tpu_torch"})


def test_whole_name_comparison(monkeypatch):
    for name in ("seesaw_tpu_torch", "seesaw_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seesaw_tpu.ops", types.ModuleType("seesaw_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert sorted(set(runner.forbidden_modules()) - set(before)) == ["jax", "seesaw_tpu.ops"]


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_no_program_module():
    code = (
        "import sys\n"
        "from loadbench.harness import reference, point\n"
        "from loadbench.harness.judge import method_check\n"
        "[method_check(m) for m in ('plain', 'rocchio_update', 'knn_prop2')]\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('seesaw_tpu_torch', 'seesaw_tpu', 'jax', 'jaxlib', 'flax')))\n")
    assert _run(code) == "[]"


def test_a_run_loads_no_jax():
    code = (
        "from loadbench.tests import tiny\n"
        "from loadbench.harness import runner\n"
        "c = tiny.cell('seesaw10m-int8-knn5.knnprop-x4', users=2)\n"
        "tiny.run(c, seconds=0.5)\n"
        "print(runner.forbidden_modules())\n")
    assert _run(code) == "[]"
