"""The port stands alone: no module of `seesaw_tpu_torch`, and not
`chip_smoke.py`, imports the JAX package (`seesaw_tpu`, any of its
modules) or jax. Checked statically on every source file, and in a fresh
process that loads the CLIP embedding; the session test
(`test_torch_session.py::test_port_session_imports_no_jax`) checks
`sys.modules` after real sessions."""
import ast
import subprocess
import sys
import textwrap
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


def test_clip_embedding_imports_no_jax():
    """Loading and running the port's CLIP leaves jax, flax and the JAX
    package out of `sys.modules`."""
    code = textwrap.dedent("""
        import sys
        from seesaw_tpu_torch.models.clip import ClipEmbedding
        from seesaw_tpu_torch.models.registry import load_embedding
        emb = ClipEmbedding("test", device="cpu")
        assert emb.from_string(string="a dog").shape == (emb.dim,)
        assert load_embedding("clip-test", "cpu").dim == emb.dim
        bad = [m for m in sys.modules
               if m in ("jax", "flax") or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
