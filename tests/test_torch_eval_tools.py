"""The port's evaluation commands against the JAX package's scripts, on the
CPU at tiny sizes:

- `python -m seesaw_tpu_torch.bench.run_bench` against `scripts/run_bench.py`
  (one yaml; the port also with two `spawn` workers);
- `python -m seesaw_tpu_torch.bench.run_method_study` against
  `scripts/run_method_study.py`;
- `python -m seesaw_tpu_torch.ingest.extract_gt_vectors` against
  `scripts/extract_gt_vectors.py` on a small `clip-custom` root (the JAX side
  reaches its Pallas attention in interpret mode);
- `python -m seesaw_tpu_torch.ingest.make_knn_graphs_batch` against
  `scripts/make_knn_graphs_batch.py`, and its `--sharded` refused without
  a card.

Tolerances: session hit indices and dbidxs equal (loops without a fitted
probe; `log_reg2` as tests/test_torch_session.py holds it, dbidxs equal);
the study's tables equal; gt vectors 1e-5 (unit vectors through one f32
layer summed in another order; the port encodes a short last batch where
the JAX script pads it); graphs by `ops.knn.assert_knn_close` at 1e-6.
Without a card every command's default device (`cuda`) is refused.
"""
import importlib.util
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import PIL.Image
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth import build_synthetic_root  # noqa: E402

import seesaw_tpu.dataset as jds  # noqa: E402
import seesaw_tpu.labeldb as jlabeldb  # noqa: E402
from seesaw_tpu.bench.harness import get_all_session_summaries  # noqa: E402
from seesaw_tpu.models import clip as J  # noqa: E402
from seesaw_tpu_torch import dataset as tds  # noqa: E402
from seesaw_tpu_torch.bench import run_bench, run_method_study  # noqa: E402
from seesaw_tpu_torch.ingest import extract_gt_vectors, make_knn_graphs_batch  # noqa: E402
from seesaw_tpu_torch.knn_graph import KNNGraph  # noqa: E402
from seesaw_tpu_torch.ops.knn import assert_knn_close  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
YAML = """\
variants:
  - {name: plain, interactive: plain}
  - {name: lr, interactive: log_reg2, max_iter: 50}
datasets: [synth]
shared_session_params:
  batch_size: 3
  shortlist_size: 20
  index_name: multiscale
  index_options: {use_pallas: true}
shared_bench_params: {n_batches: 5, max_results: 10, query_template: "a {}"}
"""
CFG = J.ClipConfig(embed_dim=16, image_size=32, patch_size=16, vision_width=128,
                   vision_layers=1, vision_heads=2, vocab_size=99, context_length=16,
                   text_width=128, text_layers=2, text_heads=2)


@pytest.fixture(autouse=True)
def _interpret_attention(monkeypatch):
    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script_main(name, argv, monkeypatch):
    """Run a JAX script whose main() reads sys.argv."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(str(SCRIPTS / f"{name}.py"), run_name="__main__")


def _summaries(out_dir: Path) -> pd.DataFrame:
    (res,) = out_dir.glob("bench_*")
    df = get_all_session_summaries(str(res), force_recompute=True)
    return df.sort_values(["variant", "category"]).reset_index(drop=True)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    r = tmp_path_factory.mktemp("tools_root")
    build_synthetic_root(str(r))
    return str(r)


@pytest.fixture(scope="module")
def yaml_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("tools_yaml") / "bench.yaml"
    p.write_text(YAML)
    return str(p)


@pytest.mark.parametrize("workers,dryrun", [(1, True), (2, False)])
def test_run_bench_matches_jax_script(synth_root, yaml_path, tmp_path, monkeypatch,
                                      workers, dryrun):
    flags = ["--dryrun"] if dryrun else []
    _run_script_main("run_bench", ["--root_dir", synth_root, "--output_dir",
                                   str(tmp_path / "jax"), *flags, yaml_path], monkeypatch)
    results_dir, runs = run_bench.main(
        ["--root_dir", synth_root, "--output_dir", str(tmp_path / "torch"),
         "--num_workers", str(workers), "--device", "cpu", *flags, yaml_path])
    want, got = _summaries(tmp_path / "jax"), _summaries(tmp_path / "torch")
    assert list(got.variant) == list(want.variant) == ["lr", "plain"]
    assert got.has_result.all()
    for (_, a), (_, b) in zip(want.iterrows(), got.iterrows()):
        np.testing.assert_array_equal(b.hit_indices, a.hit_indices)
        np.testing.assert_array_equal(b.dbidxs, a.dbidxs)
        assert b.n_batches == a.n_batches == (3 if dryrun else 5)
    assert all(r["output_dir"] is not None and r["device"] == "cpu" for r in runs)
    # kernel launches are counted on a card only
    assert sum(r["fused_frame_max_launches"] for r in runs) == 0
    assert len({r["pid"] for r in runs}) <= workers


def test_run_method_study_matches_jax_script(tmp_path, monkeypatch):
    argv = ["--n-images", "120", "--n-pos", "8", "--instances-per-tier", "1",
            "--n-batches", "4", "--methods", "plain,rocchio_update,knn_prop2",
            "--seeds", "0"]
    _run_script_main("run_method_study", [*argv, "--out", str(tmp_path / "jax"),
                                          "--workdir", str(tmp_path / "jwd")], monkeypatch)
    run_method_study.main([*argv, "--out", str(tmp_path / "torch"), "--workdir",
                           str(tmp_path / "twd"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "torch.json").read_text())
    for t in (want, got):
        t["config"].pop("wall_s")
    assert got == want and got["n_sessions"] == 9
    key = ["variant", "category"]
    pj = pd.read_parquet(tmp_path / "jax.parquet").sort_values(key).reset_index(drop=True)
    pt = pd.read_parquet(tmp_path / "torch.parquet").sort_values(key).reset_index(drop=True)
    assert list(pt.columns) == list(pj.columns)
    for c in ("hit_indices", "dbidxs"):
        for a, b in zip(pj[c], pt[c]):
            np.testing.assert_array_equal(b, a)


def _smooth(rng, h, w):
    base = rng.random((h // 16 + 2, w // 16 + 2, 3)) * 255
    return np.asarray(PIL.Image.fromarray(base.astype(np.uint8)).resize((w, h),
                                                                      PIL.Image.BICUBIC))


@pytest.fixture(scope="module")
def gt_roots(tmp_path_factory):
    """Seven JPEGs with 2 or 3 ground-truth boxes each (17; one box partly
    outside its image, one tiny), as a dataset of each package; the model is
    a `clip-custom` artifact of the JAX init."""
    base = tmp_path_factory.mktemp("gt_roots")
    artifact = base / "clip"
    artifact.mkdir()
    J.save_params_npz(J.init_params(CFG, seed=5), str(artifact / "params.npz"))
    (artifact / "info.json").write_text(json.dumps(dict(J.config_to_info(CFG), variant="custom")))
    raw = base / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    sizes = [(64, 96), (96, 64), (64, 64), (80, 100), (50, 70), (120, 90), (200, 180)]
    for i, (h, w) in enumerate(sizes):
        PIL.Image.fromarray(_smooth(rng, h, w)).save(raw / f"img_{i}.jpg", quality=95)
    dbidx, boxes, desc = [], [], []
    for i, (h, w) in enumerate(sizes):
        for j in range(2 + i % 2):
            x1, y1 = float(rng.uniform(0, w * 0.6)), float(rng.uniform(0, h * 0.6))
            dbidx.append(i)
            boxes.append((x1, y1, x1 + rng.uniform(4, w * 0.5), y1 + rng.uniform(4, h * 0.5)))
            desc.append(("car", "dog", "cup")[j])
    boxes[3] = (-10.0, 5.0, 30.0, 200.0)
    boxes[5] = (10.0, 10.0, 11.0, 11.5)
    out = {}
    for side, pkg in (("jax", jds), ("torch", tds)):
        ds = pkg.GlobalDataManager(str(base / f"{side}_root")).create_dataset(
            "gtds", image_src=str(raw))
        gt = jlabeldb.BoxTable(dbidx=np.array(dbidx, np.int32),
                               boxes=np.array(boxes, np.float32), description=desc,
                               marked_accepted=np.ones(len(dbidx), bool))
        qgt = pd.DataFrame({c: [float(c in [d for d, k in zip(desc, dbidx) if k == i])
                                for i in range(len(sizes))] for c in ("car", "dog", "cup")})
        ds.save_ground_truth(gt, qgt)
        out[side] = str(base / f"{side}_root")
    return out, f"clip-custom:{artifact}"


def test_extract_gt_vectors_matches_jax_script(gt_roots, tmp_path):
    roots, model = gt_roots
    common = ["--dataset", "gtds", "--model", model, "--padding", "8", "--batch_size", "4"]
    _script("extract_gt_vectors").main(["--root", roots["jax"], *common,
                                        "--output_path", str(tmp_path / "jax")])
    extract_gt_vectors.main(["--root", roots["torch"], *common, "--output_path",
                             str(tmp_path / "torch"), "--device", "cpu"])
    want = pd.read_parquet(tmp_path / "jax" / "gt_vectors.parquet")
    got = pd.read_parquet(tmp_path / "torch" / "gt_vectors.parquet")
    # every box is grown to a square of at least min(160, image side): 17
    # crops, so the last batch of 4 holds one
    assert len(want) == len(got) == 17
    pd.testing.assert_frame_equal(got.drop(columns="vectors"), want.drop(columns="vectors"))
    gv, wv = np.stack(got.vectors), np.stack(want.vectors)
    assert gv.shape == (17, CFG.embed_dim)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(gv, axis=1), 1.0, atol=1e-5)


def test_extract_gt_vectors_limit(gt_roots, tmp_path):
    roots, model = gt_roots
    df = extract_gt_vectors.main(["--root", roots["torch"], "--dataset", "gtds", "--model",
                                  model, "--limit", "3", "--output_path", str(tmp_path / "o"),
                                  "--device", "cpu"])
    assert sorted(set(df.dbidx)) == [0, 1, 2]


@pytest.fixture
def two_roots(tmp_path):
    out = {}
    for side in ("jax", "torch"):
        build_synthetic_root(str(tmp_path / side))
        out[side] = str(tmp_path / side)
    return out


def test_make_knn_graphs_batch_matches_jax_script(two_roots):
    common = ["--dataset", "synth", "--n_neighbors", "5", "--all_categories", "--full",
              "--factored_k_intra", "2", "--knng_name", "b5"]
    _script("make_knn_graphs_batch").main(["--root", two_roots["jax"], *common])
    make_knn_graphs_batch.main(["--root", two_roots["torch"], *common, "--device", "cpu"])
    graphs = [Path("data/synth/indices/multiscale/knn_graph/b5"),
              Path("data/synth/subsets/cat_dog/indices/multiscale/knn_graph/b5")]
    for rel in graphs:
        for name in (rel, Path(str(rel) + "_factored")):
            want = KNNGraph.from_file(Path(two_roots["jax"]) / name)
            got = KNNGraph.from_file(Path(two_roots["torch"]) / name)
            assert got.dst.shape == want.dst.shape, name
            if name == rel:
                assert want.k == 5
                assert_knn_close(got.dst, got.dist, want.dst, want.dist, 1e-6)
            else:  # factored from equal graphs: equal
                np.testing.assert_array_equal(got.dst, want.dst)
                np.testing.assert_allclose(got.dist, want.dist, atol=1e-6)
    sub = tds.GlobalDataManager(two_roots["torch"]).get_dataset("synth").load_subset("cat_dog")
    assert KNNGraph.from_file(Path(sub.path) / graphs[1].relative_to(
        "data/synth/subsets/cat_dog")).nvecs == 5 * len(sub.dbidxs)


def test_sharded_knn_build(synth_root):
    """`--sharded` builds over every visible card, so without one it is
    refused with a usage error; with one, the graph it saves equals the
    single-device build's (the mesh build itself is held against JAX in
    `tests/test_torch_sharded_graph.py`)."""
    import torch

    argv = ["--root", synth_root, "--dataset", "synth", "--sharded", "--knng_name", "mesh"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            make_knn_graphs_batch.main(argv + ["--device", "cpu"])
        return
    make_knn_graphs_batch.main(argv)
    make_knn_graphs_batch.main(["--root", synth_root, "--dataset", "synth", "--knng_name",
                                "one", "--device", "cpu"])
    base = Path(synth_root) / "data/synth/indices/multiscale/knn_graph"
    a, b = (KNNGraph.from_file(base / n) for n in ("mesh", "one"))
    assert_knn_close(a.dst, a.dist, b.dst, b.dist, 1e-6)


@pytest.mark.parametrize("cli,argv", [
    (run_bench, ["--root_dir", "r", "--output_dir", "o", "c.yaml"]),
    (run_method_study, []),
    (extract_gt_vectors, ["--root", "r", "--dataset", "d", "--output_path", "o"]),
    (make_knn_graphs_batch, ["--root", "r", "--dataset", "d"]),
])
def test_default_device_is_the_card(cli, argv, capsys):
    """Every command runs on `cuda` unless asked for the CPU: without a
    card, the default is refused before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2 and "--device cpu" in capsys.readouterr().err
