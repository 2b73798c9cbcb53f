"""The port's offline build (`seesaw_tpu_torch.ingest`, `MultiscaleIndex.save`,
`indices.coarse`, `runtime.jpeg_decode`, `models.preprocess.resize_batch`)
against the JAX package's, on the CPU.

Both sides load one `clip-custom:<dir>` artifact, written from the JAX init
of a tiny config (image_size 32, 64-wide heads, so the JAX side reaches its
Pallas attention in interpret mode and the port its kernel's plain version),
and extract 32-pixel tiles from the same small images.

Tolerances:
- geometry (boxes, zoom levels, dbidx order, host tiles) equal;
- device tiles 2e-4 after CLIP normalization: torch's antialiased resize
  computes jax.image.resize's function to ~5e-5 on [0, 1] pixels (summed in
  another order), and the normalization divides by a std of 0.26 or more;
- unit vectors 1e-5: the same tiles (or tiles within the bar above, on
  smooth images) through one f32 layer summed in another order;
- kNN graphs of the built indices by `ops.knn.assert_knn_close` at 1e-5
  (near-ties may swap under the vectors' rounding).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import PIL.Image
import pytest
import torch

import seesaw_tpu.dataset as jds
import seesaw_tpu.ingest.pipeline as jpipe
from seesaw_tpu.ingest import device_tiling as jdt
from seesaw_tpu.ingest.tiling import generate_multiscale_tiling as j_tiling
from seesaw_tpu.knn_graph import KNNGraph as JKNNGraph
from seesaw_tpu.models import clip as J
from seesaw_tpu.models.registry import load_embedding as j_load_embedding
from seesaw_tpu_torch import dataset as tds
from seesaw_tpu_torch.indices.coarse import CoarseIndex
from seesaw_tpu_torch.indices.loader import load_index
from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
from seesaw_tpu_torch.ingest import device_tiling as tdt
from seesaw_tpu_torch.ingest import pipeline as tpipe
from seesaw_tpu_torch.ingest.tiling import generate_multiscale_tiling as t_tiling
from seesaw_tpu_torch.knn_graph import KNNGraph
from seesaw_tpu_torch.models.registry import load_embedding
from seesaw_tpu_torch.ops.knn import assert_knn_close

REPO = Path(__file__).resolve().parent.parent
TILE = dict(tile_size=32, factor=0.5, min_tile_size=32)
CFG = J.ClipConfig(embed_dim=16, image_size=32, patch_size=16, vision_width=128,
                   vision_layers=1, vision_heads=2, vocab_size=99, context_length=16,
                   text_width=128, text_layers=2, text_heads=2)
SIZES = [(64, 96), (96, 64), (64, 64), (80, 100), (50, 70), (120, 90)]


def smooth_image(rng, h, w):
    """Low-frequency image (as tests/test_device_tiling.py's)."""
    base = rng.random((h // 16 + 2, w // 16 + 2, 3)) * 255
    im = PIL.Image.fromarray(base.astype(np.uint8)).resize((w, h), PIL.Image.BICUBIC)
    return np.asarray(im)


@pytest.fixture(autouse=True)
def _interpret_attention(monkeypatch):
    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    artifact = tmp_path_factory.mktemp("ingest_clip")
    J.save_params_npz(J.init_params(CFG, seed=5), str(artifact / "params.npz"))
    (artifact / "info.json").write_text(json.dumps(dict(J.config_to_info(CFG), variant="custom")))
    return f"clip-custom:{artifact}"


def _write_images(d: Path, ext: str, seed: int, corrupt: bool = False):
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(SIZES):
        PIL.Image.fromarray(smooth_image(rng, h, w)).save(d / f"img_{i}.{ext}", quality=95)
    if corrupt:
        (d / f"img_{len(SIZES)}.{ext}").write_bytes(b"not an image at all")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One JPEG image dir (with a corrupt file) as a dataset of each package,
    under separate roots."""
    base = tmp_path_factory.mktemp("ingest_roots")
    _write_images(base / "raw", "jpg", seed=0, corrupt=True)
    j = jds.GlobalDataManager(str(base / "jax_root")).create_dataset("imgs", image_src=str(base / "raw"))
    t = tds.GlobalDataManager(str(base / "torch_root")).create_dataset("imgs", image_src=str(base / "raw"))
    return j, t


def _extract(pkg, ds, emb, tiling):
    return pkg.run_multiscale_extraction(ds, emb, batch_size=16, n_decode_threads=2,
                                         tiling=tiling, **TILE)


@pytest.mark.parametrize("tiling", ["host", "device"])
def test_extraction_matches_jax(roots, model, tiling, capsys):
    jds_, tds_ = roots
    want = _extract(jpipe, jds_, j_load_embedding(model), tiling)
    got = _extract(tpipe, tds_, load_embedding(model, "cpu"), tiling)
    v_w, d_w, z_w, b_w = want
    v_g, d_g, z_g, b_g = got
    np.testing.assert_array_equal(d_g, d_w)
    np.testing.assert_array_equal(z_g, z_w)
    np.testing.assert_array_equal(b_g, b_w)
    assert v_g.dtype == np.float32 and v_g.shape == v_w.shape == (d_w.shape[0], CFG.embed_dim)
    np.testing.assert_allclose(v_g, v_w, atol=1e-5)
    # the corrupt file (dbidx 6) is skipped with a warning, the rest kept
    assert set(d_g.tolist()) == set(range(len(SIZES)))
    assert "cannot decode image for dbidx=6" in capsys.readouterr().out


def test_device_and_host_tiling_agree(roots, model):
    """Device tiles against the host path's PIL tiles, as the JAX package's
    own test holds them: same geometry, close vectors."""
    _, tds_ = roots
    emb = load_embedding(model, "cpu")
    host = _extract(tpipe, tds_, emb, "host")
    dev = _extract(tpipe, tds_, emb, "device")
    for a, b in zip(host[1:], dev[1:]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert (host[0] * dev[0]).sum(axis=1).min() > 0.98


@pytest.mark.parametrize("h,w,ts", [(480, 640, 224), (150, 200, 224), (65, 97, 32),
                                    (20, 30, 32), (300, 500, 224)])
def test_device_tiles_match_jax(h, w, ts):
    """Smaller than the tile (enlarged), 1 and 2 levels, shrinking."""
    img = np.random.default_rng(h * w).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    plan_j, want = jdt.tile_on_device(img, ts, 0.5, ts)
    plan_t, got = tdt.tile_on_device(img, ts, 0.5, ts, device="cpu")
    np.testing.assert_array_equal(plan_t.boxes, plan_j.boxes)
    np.testing.assert_array_equal(plan_t.zoom_level, plan_j.zoom_level)
    assert [(lv.th, lv.tw) for lv in plan_t.levels] == [(lv.th, lv.tw) for lv in plan_j.levels]
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_batch_tiler_equals_per_image_tiler():
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(np.stack([smooth_image(rng, 64, 96) for _ in range(3)]))
    plan = tdt.make_plan(64, 96, 32, 0.5, 32)
    got = tdt.build_batch_tiler(plan, 3)(imgs)
    want = torch.cat([tdt.build_tiler(plan)(im) for im in imgs])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_host_tiling_copy_equals_jax():
    img = PIL.Image.fromarray(smooth_image(np.random.default_rng(4), 300, 500))
    want, got = j_tiling(img, tile_size=224), t_tiling(img, tile_size=224)
    for f in ("tiles", "boxes", "zoom_level", "scale_factor"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.max_zoom_level == want.max_zoom_level


@pytest.mark.parametrize("hw", [(24, 30), (100, 150), (48, 64), (37, 97)])
def test_resize_batch_matches_jax(hw):
    """Bicubic with antialias, shrinking, enlarging and unchanged: f32 sums
    in another order (measured 2.1e-6)."""
    import jax.numpy as jnp

    from seesaw_tpu.models.preprocess import resize_batch_jax
    from seesaw_tpu_torch.models.preprocess import resize_batch

    x = np.random.default_rng(0).random((2, 48, 64, 3)).astype(np.float32)
    want = np.asarray(resize_batch_jax(jnp.asarray(x), hw))
    got = resize_batch(torch.from_numpy(x), hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _vectors_npz(path):
    with np.load(Path(path) / "vectors.npz") as z:
        return {k: z[k] for k in z.files}


def test_create_indices_match_jax_and_load_both_ways(roots, model):
    jds_, tds_ = roots
    kw = dict(batch_size=16, force=True, build_knn_graph=4, **TILE)
    j_idx = jpipe.create_multiscale_index(jds_, "ms", model, **kw)
    t_idx = tpipe.create_multiscale_index(tds_, "ms", model, device="cpu", **kw)
    assert isinstance(t_idx, MultiscaleIndex) and t_idx.device.type == "cpu"
    want, got = _vectors_npz(jds_.index_path("ms")), _vectors_npz(tds_.index_path("ms"))
    assert set(got) == set(want)
    for k in ("dbidx", "zoom_level", "boxes"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["vectors"], want["vectors"], atol=1e-5)
    info_w = json.loads((Path(jds_.index_path("ms")) / "info.json").read_text())
    info_g = json.loads((Path(tds_.index_path("ms")) / "info.json").read_text())
    assert info_g["constructor"] == info_w["constructor"] and info_g["model"] == model
    g_w = JKNNGraph.from_file(j_idx.get_knng_path(""))
    g_g = KNNGraph.from_file(t_idx.get_knng_path(""))
    assert_knn_close(g_g.dst, g_g.dist, g_w.dst, g_w.dist, 1e-5)

    # each package loads the other's index
    j_from_t = jds.SeesawDataset(tds_.path).load_index("ms", options={})
    t_from_j = tds.SeesawDataset(jds_.path).load_index("ms", device="cpu")
    np.testing.assert_array_equal(j_from_t.vectors, t_idx.vectors)
    np.testing.assert_array_equal(t_from_j.vectors, j_idx.vectors)
    q = t_idx.vectors[3]
    assert (t_idx.query(vector=q, topk=3, shortlist_size=6)["dbidxs"].tolist()
            == j_from_t.query(vector=q, topk=3, shortlist_size=6)["dbidxs"].tolist())

    # coarse indices of both packages, each loaded by the other
    jc = jpipe.create_coarse_index(jds_, "coarse", from_index="ms", force=True)
    tc = tpipe.create_coarse_index(tds_, "coarse", from_index="ms", device="cpu", force=True)
    assert isinstance(tc, CoarseIndex) and tc.vectors.shape[0] == len(SIZES)
    np.testing.assert_array_equal(tc.meta.dbidx, jc.meta.dbidx)
    np.testing.assert_allclose(tc.vectors, jc.vectors, atol=1e-5)
    j_coarse = jds.SeesawDataset(tds_.path).load_index("coarse", options={})
    t_coarse = load_index(jds_.index_path("coarse"), device="cpu")
    assert type(j_coarse).__name__ == "CoarseIndex" and isinstance(t_coarse, CoarseIndex)
    np.testing.assert_array_equal(t_coarse.vectors, jc.vectors)
    res = tc.query(vector=tc.vectors[2], topk=2)
    assert res["dbidxs"][0] == tc.meta.frame_dbidx[2]
    assert (res["dbidxs"].tolist()
            == j_coarse.query(vector=tc.vectors[2], topk=2)["dbidxs"].tolist())


def test_coarse_query_labels_images(roots, model, tmp_path):
    """Image-level binary labels, as the JAX CoarseQuery gives them."""
    from seesaw_tpu_torch.basic_types import Box

    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(5, 8)).astype(np.float32)
    idx = CoarseIndex(device="cpu", vectors=vecs, dbidx=np.array([4, 0, 3, 1, 2]))
    q = idx.new_query()
    q.label_db.put(0, [Box(x1=0, y1=0, x2=1, y2=1, marked_accepted=True)])
    q.label_db.put(3, [])
    pos, neg = q.getXy(get_positions=True)
    assert idx.meta.dbidx[pos].tolist() == [0] and idx.meta.dbidx[neg].tolist() == [3]
    idx.save(str(tmp_path / "c"), model_name="hash-8")
    back = load_index(str(tmp_path / "c"), device="cpu")
    np.testing.assert_array_equal(back.vectors, idx.vectors)
    np.testing.assert_array_equal(back.meta.dbidx, idx.meta.dbidx)


def test_save_round_trip_both_packages(tmp_path):
    """An index saved by the port loads in the JAX package, and a JAX-saved
    one in the port, with the same vectors, metadata and exclusions."""
    from seesaw_tpu.indices.interface import AccessMethod
    from seesaw_tpu.indices.meta import VectorMeta as JMeta
    from seesaw_tpu.indices.multiscale import MultiscaleIndex as JIndex
    from seesaw_tpu_torch.indices.meta import VectorMeta
    from seesaw_tpu_torch.runtime.bitmap import BitMap

    rng = np.random.default_rng(7)
    dbidx = np.repeat(np.arange(6), 3).astype(np.int32)[::-1].copy()
    zoom = np.tile([1, 1, 2], 6).astype(np.int32)
    boxes = rng.random((18, 4)).astype(np.float32)
    vecs = rng.normal(size=(18, 8)).astype(np.float32)
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    idx = MultiscaleIndex(device="cpu", vectors=vecs[order], meta=meta, excluded=BitMap([2]))
    idx.save(str(tmp_path / "t"), model_name="hash-8")
    j = AccessMethod.load(str(tmp_path / "t"), options={})
    np.testing.assert_array_equal(j.vectors, idx.vectors)
    np.testing.assert_array_equal(j.meta.dbidx, idx.meta.dbidx)
    assert j.excluded.to_array().tolist() == [2]

    jmeta, jorder = JMeta.from_arrays(dbidx, zoom, boxes)
    JIndex(vectors=vecs[jorder], meta=jmeta).save(str(tmp_path / "j"), model_name="hash-8")
    back = load_index(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(back.vectors, idx.vectors)
    np.testing.assert_array_equal(back.meta.boxes, idx.meta.boxes)
    assert back.embedding.dim == 8


def test_rebuild_with_force_serves_the_new_index(roots, model):
    """The port's loader cache is dropped on a rebuild (and on save): a
    second build with force=True at the same path is what loads next."""
    _, tds_ = roots
    kw = dict(batch_size=16, **TILE)
    small = tpipe.create_multiscale_index(tds_, "rebuilt", model, device="cpu", limit=2,
                                          force=True, **kw)
    assert tds_.load_index("rebuilt", device="cpu") is small
    assert small.n_frames == 2
    full = tpipe.create_multiscale_index(tds_, "rebuilt", model, device="cpu", force=True, **kw)
    again = tds_.load_index("rebuilt", device="cpu")
    assert again is full and again.n_frames == len(SIZES)
    with pytest.raises(FileExistsError):
        tpipe.create_multiscale_index(tds_, "rebuilt", model, device="cpu", **kw)
    sub = full.subset(full.all_indices.difference(type(full.all_indices)([0, 1])))
    sub.save(tds_.index_path("rebuilt"), model_name=model)
    assert tds_.load_index("rebuilt", device="cpu").n_frames == len(SIZES) - 2


def test_a_dead_stage_raises(roots, model, monkeypatch):
    """A failing upload thread surfaces as an error, never a hang."""
    _, tds_ = roots

    def boom(*a, **k):
        raise ValueError("planted")

    monkeypatch.setattr(tpipe, "make_plan", boom)
    with pytest.raises(RuntimeError, match="decode/upload stage failed"):
        _extract(tpipe, tds_, load_embedding(model, "cpu"), "device")


def test_mesh_extraction_equals_one_device(roots, model):
    """The data-parallel extraction over a 3-shard CPU mesh (batches
    rounded up to 18, split into slices) gives the single-device
    extraction's rows in the same order, vectors within
    rtol 1e-5 / atol 1e-6 (f32 sums of other batch shapes), in both
    tilings; `KNNGraph.build(mesh=)` gives the single-device graph
    (`tests/test_torch_sharded_graph.py` holds both against JAX)."""
    from seesaw_tpu_torch.parallel.mesh import make_mesh

    _, tds_ = roots
    emb = load_embedding(model, "cpu")
    mesh = make_mesh(devices=["cpu"] * 3)
    for tiling in ("host", "device"):
        v_w, *meta_w = _extract(tpipe, tds_, emb, tiling)
        v_g, *meta_g = tpipe.run_multiscale_extraction(
            tds_, emb, batch_size=16, n_decode_threads=2, tiling=tiling, mesh=mesh, **TILE)
        for g, w in zip(meta_g, meta_w):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(v_g, v_w, rtol=1e-5, atol=1e-6)
    V = np.eye(4, dtype=np.float32) + 0.1
    g = KNNGraph.build(V, 2, mesh=mesh)
    one = KNNGraph.build(V, 2, device="cpu")
    np.testing.assert_array_equal(g.dst, one.dst)
    np.testing.assert_allclose(g.dist, one.dist, atol=1e-6)


def test_infer_coarse_vectors_equals_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(40, 8)).astype(np.float32)
    d = rng.integers(0, 7, 40)
    z = rng.integers(1, 4, 40).astype(np.int32)
    for a, b in zip(tpipe.infer_coarse_vectors(v, d, z), jpipe.infer_coarse_vectors(v, d, z)):
        np.testing.assert_array_equal(a, b)


def test_jpeg_decode_pool(tmp_path):
    """The port's decode pool (native where it builds, PIL otherwise) gives
    PIL's pixels, (i, None) for an undecodable file, and builds only under
    build/seesaw_tpu_torch/."""
    from seesaw_tpu_torch.runtime import jpeg_decode as jd

    rng = np.random.default_rng(0)
    paths, want = [], []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (120, 200)]):
        p = tmp_path / f"im_{i}.jpg"
        PIL.Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(p, quality=95)
        paths.append(str(p))
        want.append(np.asarray(PIL.Image.open(p).convert("RGB")))
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8garbage")
    paths.append(str(tmp_path / "bad.jpg"))
    for native in (True, False):
        got = dict(jd.decode_pool(paths, n_threads=2, prefer_native=native))
        assert sorted(got) == [0, 1, 2, 3] and got[3] is None
        for i, w in enumerate(want):
            # libjpeg's and PIL's IDCTs may round a pixel apart
            assert got[i].shape == w.shape
            assert np.abs(got[i].astype(int) - w.astype(int)).max() <= 2
    assert jd._LIB_PATH.parent == REPO / "build" / "seesaw_tpu_torch"
    if jd.native_available():
        assert jd._LIB_PATH.exists()


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env, text=True,
                          capture_output=True, timeout=300, **kw)


def test_build_scripts_on_the_cpu(roots, model):
    """`python -m seesaw_tpu_torch.ingest.build_index` / `.make_knn_graph`
    with --device cpu build an index, its graph, a coarse index and a
    factored graph; without a card the default device fails."""
    _, tds_ = roots
    out = _run(["seesaw_tpu_torch.ingest.build_index", "--dataset_path", tds_.path,
                "--index_name", "cli", "--model", model, "--tile_size", "32",
                "--min_tile_size", "32", "--batch_size", "16", "--knn_k", "3",
                "--coarse_name", "cli_coarse", "--device", "cpu", "--force"])
    assert out.returncode == 0, out.stderr
    idx = tds_.load_index("cli", device="cpu")
    assert KNNGraph.from_file(idx.get_knng_path("")).k == 3
    assert isinstance(tds_.load_index("cli_coarse", device="cpu"), CoarseIndex)
    out = _run(["seesaw_tpu_torch.ingest.make_knn_graph", "--dataset_path", tds_.path,
                "--index_name", "cli", "--graph_name", "k5", "--n_neighbors", "5",
                "--k_intra", "1", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert KNNGraph.from_file(idx.get_knng_path("k5")).k == 5
    assert KNNGraph.from_file(idx.get_knng_path("k5_factored")).nvecs == idx.meta.n_vectors
    if not torch.cuda.is_available():
        out = _run(["seesaw_tpu_torch.ingest.make_knn_graph", "--dataset_path", tds_.path,
                    "--index_name", "cli"])
        assert out.returncode != 0 and "--device cpu" in out.stderr


@pytest.mark.parametrize("method,hw", [("bilinear", (224, 298)), ("bilinear", (1000, 1333)),
                                       ("bicubic", (224, 298)), ("bicubic", (1000, 1333))])
def test_antialias_is_what_matches_jax(method, hw):
    """Random [0, 1] 480 x 640 pixels, shrunk and enlarged: torch's resize
    with antialias=True computes jax.image.resize(antialias=True)'s function
    (within 1e-4), and without it does not (it neither widens the kernel
    when shrinking nor, for bicubic, uses JAX's a = -0.5): the differences
    print with -s."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    x = np.random.default_rng(0).random((480, 640, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (*hw, 3), method=method,
                                       antialias=True))
    t = torch.from_numpy(x).permute(2, 0, 1)[None]
    err = {}
    for aa in (True, False):
        got = F.interpolate(t, size=hw, mode=method, antialias=aa, align_corners=False)
        err[aa] = float(np.abs(got[0].permute(1, 2, 0).numpy() - want).max())
    print(f"{method} 480x640 -> {hw}: max diff antialias=True {err[True]!r}, "
          f"False {err[False]!r}")
    assert err[True] <= 1e-4
    if hw[0] < 480 or method == "bicubic":
        assert err[False] > 50 * err[True]


def test_create_dataset_command_matches_jax(tmp_path):
    """`python -m seesaw_tpu_torch.ingest.create_dataset` and
    `scripts/create_dataset.py` write the same dataset directory from one
    image folder: the same `file_meta.parquet` table and an `images/` link
    to the folder; both refuse an existing directory without `--force` and
    replace it with it."""
    import pandas as pd

    _write_images(tmp_path / "raw", "jpg", seed=3)
    (tmp_path / "raw" / "sub").mkdir()
    PIL.Image.new("RGB", (8, 8)).save(tmp_path / "raw" / "sub" / "a.png")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmds = {"jax": [sys.executable, str(REPO / "scripts" / "create_dataset.py")],
            "torch": [sys.executable, "-m", "seesaw_tpu_torch.ingest.create_dataset"]}
    for side, cmd in cmds.items():
        argv = cmd + ["--image_dir", str(tmp_path / "raw"),
                      "--output_path", str(tmp_path / side)]
        for extra, ok in (([], True), ([], False), (["--force"], True)):
            out = subprocess.run(argv + extra, cwd=REPO, env=env, capture_output=True,
                                 text=True, timeout=120)
            assert (out.returncode == 0) == ok, (side, extra, out.stderr)
    tables = [pd.read_parquet(tmp_path / side / "file_meta.parquet") for side in cmds]
    pd.testing.assert_frame_equal(tables[0], tables[1])
    assert len(tables[0]) == len(SIZES) + 1
    for side in cmds:
        assert os.path.realpath(tmp_path / side / "images") == str((tmp_path / "raw").resolve())
    assert tds.SeesawDataset(str(tmp_path / "torch")).file_path(0) == \
        jds.SeesawDataset(str(tmp_path / "jax")).file_path(0)
