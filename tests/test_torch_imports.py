"""The port stands alone: no module of `seesaw_tpu_torch`, and not
`chip_smoke.py`, imports the JAX package (`seesaw_tpu`, any of its
modules), jax, flax or optax. Checked statically on every source file, and
in fresh processes that load the CLIP embedding, fine-tune it and train the
textual feedback model; the session test
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
FORBIDDEN = ("seesaw_tpu", "jax", "flax", "optax")


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
               if m in ("jax", "flax", "optax") or m == "seesaw_tpu"
               or m.startswith("seesaw_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_training_modules_import_no_jax():
    """A fine-tuning step, an OnlineModel update in both modes and the
    textual loop's module leave jax, flax, optax and the JAX package out of
    `sys.modules`."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from seesaw_tpu_torch.loops.registry import REGISTRY
        from seesaw_tpu_torch.models.clip import ClipEmbedding
        from seesaw_tpu_torch.models.clip_finetune import CLIPFineTuner
        from seesaw_tpu_torch.models.online_model import OnlineModel
        emb = ClipEmbedding("test", device="cpu")
        rng = np.random.default_rng(0)
        px = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
        toks = rng.integers(1, 127, size=(4, 16)).astype(np.int32)
        ft = CLIPFineTuner(emb, {"opt_config": {"": {"lr": 1e-3}}}, device="cpu")
        ft.fit(px, toks, batch_size=4)
        vecs = rng.normal(size=(6, emb.dim)).astype(np.float32)
        acc = np.array([True, False] * 3)
        ann = np.array(["a dog", "a cat"] * 3, dtype=object)
        for mode in ("linear", "finetune"):
            m = OnlineModel(emb, {"mode": mode, "rounds": 2}, device="cpu")
            m.update(vecs, acc, ann, target_string="a dog")
            assert m.score_vecs(vecs).shape == (6,)
        assert "textual" in REGISTRY
        bad = [m for m in sys.modules
               if m in ("jax", "flax", "optax") or m == "seesaw_tpu"
               or m.startswith("seesaw_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_offline_build_imports_no_jax(tmp_path):
    """The offline build (ingest, the kNN build, the coarse index, the JPEG
    pool, the converter) and its `python -m` entry points leave jax, flax,
    optax and the JAX package out of `sys.modules`."""
    code = textwrap.dedent("""
        import runpy, sys
        import numpy as np
        import seesaw_tpu_torch.ingest as ingest
        from seesaw_tpu_torch.indices.coarse import CoarseIndex
        from seesaw_tpu_torch.ingest import device_tiling, pipeline
        from seesaw_tpu_torch.knn_graph import KNNGraph, factor_neighbors
        from seesaw_tpu_torch.models import convert_checkpoint
        from seesaw_tpu_torch.ops.knn import exact_knn
        from seesaw_tpu_torch.runtime import jpeg_decode
        X = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
        g = KNNGraph.build(X, 4, device="cpu")
        factor_neighbors(g, np.arange(50) // 5, k_intra=1)
        plan, tiles = device_tiling.tile_on_device(
            np.zeros((40, 50, 3), np.uint8), 32, 0.5, 32, device="cpu")
        assert tiles.shape == (plan.n_tiles, 32, 32, 3)
        CoarseIndex(device="cpu", vectors=X[:5], dbidx=np.arange(5))
        for mod in ("seesaw_tpu_torch.ingest.build_index",
                    "seesaw_tpu_torch.ingest.make_knn_graph",
                    "seesaw_tpu_torch.models.convert_checkpoint"):
            sys.argv = [mod, "--help"]
            try:
                runpy.run_module(mod, run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, e.code
        bad = [m for m in sys.modules
               if m in ("jax", "flax", "optax") or m == "seesaw_tpu"
               or m.startswith("seesaw_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_web_server_imports_no_jax(tmp_path):
    """The port's web server (sessions over HTTP, the coalescer, `/explore`
    with the embedding map, `python -m seesaw_tpu_torch.web.serve`) on a root
    the port writes leaves jax, flax, optax and the JAX package out of
    `sys.modules`; the server threads import lazily, so the check comes after
    the requests."""
    code = textwrap.dedent(f"""
        import json, runpy, sys, urllib.request
        import numpy as np
        from seesaw_tpu_torch import GlobalDataManager, VectorMeta
        from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
        from seesaw_tpu_torch.web import SeesawServer
        from seesaw_tpu_torch.web.coalesce import CoalescingIndex
        root = {str(tmp_path / "root")!r}
        ds = GlobalDataManager(root).create_dataset(
            "d", paths=[f"img_{{i}}.jpg" for i in range(20)])
        rng = np.random.default_rng(0)
        boxes = np.tile(np.array([[0, 0, 10, 10], [0, 0, 20, 20]], np.float32), (20, 1))
        meta, order = VectorMeta.from_arrays(np.repeat(np.arange(20), 2),
                                             np.tile([1, 2], 20), boxes)
        vecs = rng.normal(size=(40, 16)).astype(np.float32)[order]
        MultiscaleIndex(device="cpu", vectors=vecs, meta=meta).save(
            ds.index_path("multiscale"), model_name="hash-16")
        assert isinstance(MultiscaleIndex.from_path(ds.index_path("multiscale"),
                                                    device="cpu", coalesce_ms=3),
                          CoalescingIndex)
        app = SeesawServer(root, {str(tmp_path / "save")!r}, device="cpu")
        httpd = app.serve(port=0)
        base = f"http://127.0.0.1:{{httpd.server_address[1]}}"
        cookie = None
        def post(path, body=None):
            global cookie
            req = urllib.request.Request(base + path, method="POST",
                data=json.dumps(body).encode() if body is not None else b"")
            if cookie:
                req.add_header("Cookie", f"session_id={{cookie}}")
            with urllib.request.urlopen(req) as r:
                sc = r.headers.get("Set-Cookie")
                if sc:
                    cookie = sc.split("session_id=")[1].split(";")[0]
                return json.loads(r.read())
        post("/user_session?mode=plain&dataset=d&index=multiscale")
        state = post("/text?key=a+dog")
        post("/next", {{"client_data": state}})
        with urllib.request.urlopen(base + "/explore?dataset=d&clusters=3&q=a+dog") as r:
            assert "embedding map" in r.read().decode()
        httpd.shutdown()
        sys.argv = ["serve", "--help"]
        try:
            runpy.run_module("seesaw_tpu_torch.web.serve", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = [m for m in sys.modules
               if m in ("jax", "flax", "optax") or m == "seesaw_tpu"
               or m.startswith("seesaw_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
