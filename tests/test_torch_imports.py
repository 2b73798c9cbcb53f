"""The port stands alone: no module of `seesaw_tpu_torch`, and not
`chip_smoke.py`, imports the JAX package (`seesaw_tpu`, any of its
modules) or jax. Checked statically on every source file; the session test
(`test_torch_session.py::test_port_session_imports_no_jax`) checks
`sys.modules` after real sessions."""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "seesaw_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("seesaw_tpu", "jax", "flax")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_imports_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_sources_found():
    assert len(SOURCES) > 30
