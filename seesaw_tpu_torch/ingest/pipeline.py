"""Extraction pipeline: dataset images -> multiscale CLIP vectors -> index.

Counterpart of `seesaw_tpu/ingest/pipeline.py`: a thread pool decodes (and,
with host tiling, tiles) the images; the tiles cross to the embedding's
device as uint8 (4x less transfer than f32), are normalized there, and are
encoded in batches of `batch_size` by `encode_image_batch` (the ViT, whose
attention is the hand-written kernel on the card). With device tiling the
host only decodes: each decoded image crosses once and `device_tiling`
makes its tiles on the device. Each batch's vectors are copied back one
batch behind, so the card encodes batch i+1 while the host takes batch i.

With a `mesh` of several devices the extraction is data-parallel, as the
JAX package's: the batch is rounded up to a multiple of the shard count S
and split into S contiguous slices, the vision tower is replicated once per
distinct device of the mesh, and each slice is encoded on its shard's
device; the vectors come back in the single-device order. Both tilings take
a mesh (the JAX package's device tiling does not). Over a mesh that spans
processes every process decodes and tiles every image, encodes its own
shards' slices (the last ones zero-padded to the slice size), and one
gather a batch gives every process the whole batch's vectors.

Kept from the JAX package: a dead decode or upload thread forwards its
exception and the run raises (never hangs); undecodable images are skipped
with a warning; the vectors are renormalized on the host
(`max(norm, 1e-6)`) and stably sorted by dbidx.

Left out, as TPU workarounds the card does not need: the zero padding of
the last batch to a fixed shape (one compile per shape under jit), and the
grouping of same-size images into 48-image tiler dispatches (it amortized a
remote link's per-dispatch round trip; here each image is one upload and a
few launches).
"""
from __future__ import annotations

import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import PIL.Image
import torch

from ..indices.coarse import CoarseIndex
from ..indices.loader import index_cache
from ..indices.meta import VectorMeta
from ..indices.multiscale import MultiscaleIndex
from ..models.preprocess import normalize_pixels
from ..models.registry import load_embedding
from ..parallel.mesh import gather_to
from ..utils.transactional import transactional_folder
from .device_tiling import build_tiler, make_plan
from .tiling import generate_multiscale_tiling

_SENTINEL = object()
_STAGE_ERROR = object()  # (_STAGE_ERROR, exc): a stage died; the consumer raises


def _device_of(embedding) -> torch.device:
    """The device the embedding encodes on; a host model (`hash-<d>`) has
    none and takes its pixels on the CPU."""
    return torch.device(getattr(embedding, "device", "cpu"))


def replicate_embedding(embedding, mesh) -> list:
    """The embedding on each shard's device of `mesh`: one copy of the
    tower per distinct device (`replica`), the embedding itself where it
    already is; a host model (no `replica`) serves every shard."""
    if not hasattr(embedding, "replica"):
        return [embedding] * len(mesh.devices)
    on = {d: embedding.replica(d) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


class _BatchEncoder:
    """Encodes batches of CLIP-normalized tiles and collects the vectors on
    the host one batch behind: batch i's copies are waited for only after
    batch i+1 is enqueued. With a mesh, each batch is split into contiguous
    slices, slice s encoded by shard s's replica on its device; over a
    process mesh, this process's slices, gathered from every process."""

    def __init__(self, embedding, mesh=None):
        self.embedding = embedding
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.replicas = None if self.mesh is None else replicate_embedding(embedding, mesh)
        self.vectors: list[np.ndarray] = []
        self._pending = []  # [(host tensor or array, CUDA event or None)] of a batch

    def submit(self, pixels: torch.Tensor):
        if self.mesh is not None and self.mesh.group is not None:
            self._submit_spmd(pixels)
            return
        if self.replicas is None:
            parts = [(self.embedding, pixels)]
        else:
            per = -(-pixels.shape[0] // self.mesh.size)
            parts = [(emb, pixels[s * per:(s + 1) * per].to(_device_of(emb)))
                     for s, emb in enumerate(self.replicas) if s * per < pixels.shape[0]]
        pending = []
        for emb, px in parts:
            vecs = emb.encode_image_batch(px)
            event = None
            if isinstance(vecs, torch.Tensor):
                vecs = vecs.to(torch.float32)
                if vecs.device.type == "cuda":
                    vecs = vecs.to("cpu", non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
            pending.append((vecs, event))
        self._harvest()
        self._pending = pending

    def _submit_spmd(self, pixels: torch.Tensor):
        """Over a process mesh: this process's slices of ceil(B / S) tiles
        (the batch's tail zero-padded), then one gather of every shard's
        vectors, in shard order, onto the host."""
        m, B = self.mesh, pixels.shape[0]
        per = -(-B // m.size)
        parts = []
        for s, emb in zip(m.local_shards, self.replicas):
            px = pixels[s * per:(s + 1) * per]
            if px.shape[0] < per:
                px = torch.cat([px, px.new_zeros((per - px.shape[0], *px.shape[1:]))])
            vecs = torch.as_tensor(emb.encode_image_batch(px.to(_device_of(emb))))
            parts.append(vecs.to(torch.float32))
        self._harvest()
        self.vectors.append(gather_to(m, parts, device="cpu")[:B].numpy())

    def _harvest(self):
        for vecs, event in self._pending:
            if event is not None:
                event.synchronize()
            self.vectors.append(np.asarray(vecs, dtype=np.float32))
        self._pending = []

    def finish(self) -> np.ndarray:
        """All vectors in submission order, renormalized on the host."""
        self._harvest()
        if not self.vectors:
            raise RuntimeError("extraction produced zero vectors: no image decoded successfully")
        out = np.concatenate(self.vectors)
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-6)


def _sorted_by_dbidx(vectors, dbidx, zoom, boxes):
    order = np.argsort(dbidx, kind="stable")
    return vectors[order], dbidx[order], zoom[order], boxes[order]


def _raise_stage_error(item, what: str):
    if isinstance(item, tuple) and len(item) == 2 and item[0] is _STAGE_ERROR:
        raise RuntimeError(f"ingest {what} stage failed") from item[1]


def run_multiscale_extraction(
    ds,
    embedding,
    *,
    tile_size: int = 224,
    factor: float = 0.5,
    min_tile_size: int = 224,
    batch_size: int = 256,
    n_decode_threads: int = 8,
    limit: Optional[int] = None,
    mesh=None,
    tiling: str = "host",
):
    """Returns (vectors (N, D), dbidx, zoom_level, boxes) sorted by dbidx.

    The tiles are encoded on the embedding's device, or data-parallel over
    `mesh` (batches rounded up to a multiple of its size). tiling='device'
    makes the pyramid and grids on the embedding's device
    (`ingest.device_tiling`): the host only decodes, and the raw image is
    the only transfer."""
    if mesh is not None and mesh.size > 1:
        batch_size = -(-batch_size // mesh.size) * mesh.size
    if tiling == "device":
        return _run_device_tiling_extraction(
            ds, embedding, tile_size=tile_size, factor=factor,
            min_tile_size=min_tile_size, batch_size=batch_size,
            n_decode_threads=n_decode_threads, limit=limit, mesh=mesh,
        )
    if tiling != "host":
        raise ValueError(f"unknown tiling {tiling!r}")
    device = _device_of(embedding)
    dbidxs = ds.dbidxs[:limit] if limit else ds.dbidxs
    work_q: "queue.Queue" = queue.Queue(maxsize=n_decode_threads * 2)

    def decode_one(dbidx):
        try:
            im = PIL.Image.open(ds.file_path(int(dbidx)))
            ts = generate_multiscale_tiling(
                im, tile_size=tile_size, factor=factor, min_tile_size=min_tile_size
            )
            return (int(dbidx), ts)
        except Exception as e:  # unreadable/missing/truncated image: skip
            print(f"warning: cannot decode image for dbidx={dbidx} ({e!r}); skipping")
            return None

    def producer():
        # ANY exit enqueues a terminal item: a producer dying without one
        # would leave the consumer blocked on work_q.get() forever
        try:
            with ThreadPoolExecutor(n_decode_threads) as pool:
                for res in pool.map(decode_one, dbidxs):
                    work_q.put(res)
        except BaseException as e:  # noqa: BLE001 — surfaced by the consumer
            work_q.put((_STAGE_ERROR, e))
        else:
            work_q.put(_SENTINEL)

    threading.Thread(target=producer, daemon=True).start()

    # cross-image batching: tiles of many images fill each batch
    encoder = _BatchEncoder(embedding, mesh)
    buf_tiles, metas = [], []
    n_buf = 0

    def flush(final=False):
        nonlocal buf_tiles, n_buf
        while n_buf >= batch_size or (final and n_buf > 0):
            tiles = np.concatenate(buf_tiles) if len(buf_tiles) > 1 else buf_tiles[0]
            take = min(batch_size, n_buf)
            px = torch.from_numpy(np.ascontiguousarray(tiles[:take])).to(device)
            encoder.submit(normalize_pixels(px.to(torch.float32) / 255.0))
            buf_tiles = [tiles[take:]] if take < tiles.shape[0] else []
            n_buf -= take

    while True:
        item = work_q.get()
        if item is _SENTINEL:
            break
        if item is None:
            continue
        _raise_stage_error(item, "decode")
        dbidx, ts = item
        n_tiles = ts.tiles.shape[0]
        buf_tiles.append(ts.tiles)
        metas.append((np.full(n_tiles, dbidx, dtype=np.int32), ts.zoom_level, ts.boxes))
        n_buf += n_tiles
        flush()
    flush(final=True)
    vectors = encoder.finish()
    dbidx, zoom, boxes = (np.concatenate([m[i] for m in metas]) for i in range(3))
    return _sorted_by_dbidx(vectors, dbidx, zoom, boxes)


def _run_device_tiling_extraction(
    ds, embedding, *, tile_size, factor, min_tile_size, batch_size,
    n_decode_threads, limit, mesh=None,
):
    """Decode on host threads (the native C++ libjpeg pool for JPEGs where it
    builds, PIL otherwise); an upload thread sends each decoded image to the
    device and tiles it there; the calling thread cuts the device tiles into
    batches and encodes them. Tiles never return to the host."""
    from ..runtime.jpeg_decode import decode_pool

    device = _device_of(embedding)
    dbidxs = ds.dbidxs[:limit] if limit else ds.dbidxs
    work_q: "queue.Queue" = queue.Queue(maxsize=n_decode_threads * 2)
    paths = [ds.file_path(int(i)) for i in dbidxs]
    jpeg_only = all(str(p).lower().endswith((".jpg", ".jpeg")) for p in paths)

    def producer():
        # ANY exit enqueues a terminal item (a dead producer would leave
        # the uploader blocked on work_q.get() forever)
        try:
            for i, img in decode_pool(paths, n_threads=n_decode_threads,
                                      prefer_native=jpeg_only):
                if img is None:
                    print(f"warning: cannot decode image for dbidx={dbidxs[i]}; skipping")
                    continue
                work_q.put((int(dbidxs[i]), img))
        except BaseException as e:  # noqa: BLE001 — forwarded to the main thread
            work_q.put((_STAGE_ERROR, e))
        else:
            work_q.put(_SENTINEL)

    # a few images' tiles in flight: enough to fill the next batch while
    # the current one encodes
    tiles_q: "queue.Queue" = queue.Queue(maxsize=max(2, 2 * batch_size // 16))

    def uploader():
        try:
            while True:
                item = work_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, tuple) and item[0] is _STAGE_ERROR:
                    tiles_q.put(item)  # forward the decode-stage failure
                    return
                dbidx, img = item
                h, w = img.shape[:2]
                plan = make_plan(h, w, tile_size, factor, min_tile_size)
                # PIL's arrays are read-only: copy those (torch wants writable)
                img_d = torch.from_numpy(np.require(img, requirements=("C", "W"))).to(device)
                tiles_q.put((build_tiler(plan)(img_d), dbidx, plan))
            tiles_q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — surfaced to the main thread
            tiles_q.put((_STAGE_ERROR, e))

    threading.Thread(target=producer, daemon=True).start()
    threading.Thread(target=uploader, daemon=True).start()

    encoder = _BatchEncoder(embedding, mesh)
    buf_tiles, metas = [], []
    n_buf = 0

    def flush(final=False):
        nonlocal buf_tiles, n_buf
        while n_buf >= batch_size or (final and n_buf > 0):
            cat = buf_tiles[0] if len(buf_tiles) == 1 else torch.cat(buf_tiles)
            take = min(batch_size, n_buf)
            encoder.submit(cat[:take])
            buf_tiles = [cat[take:]] if take < n_buf else []
            n_buf -= take

    while True:
        item = tiles_q.get()
        if item is _SENTINEL:
            break
        _raise_stage_error(item, "decode/upload")
        tiles_d, dbidx, plan = item
        buf_tiles.append(tiles_d)
        metas.append((np.full(plan.n_tiles, dbidx, dtype=np.int32), plan.zoom_level,
                      plan.boxes))
        n_buf += plan.n_tiles
        flush()
    flush(final=True)
    vectors = encoder.finish()
    dbidx, zoom, boxes = (np.concatenate([m[i] for m in metas]) for i in range(3))
    return _sorted_by_dbidx(vectors, dbidx, zoom, boxes)


def create_multiscale_index(
    ds,
    index_name: str,
    model_name: str,
    *,
    device,
    tile_size: int = 224,
    factor: float = 0.5,
    min_tile_size: int = 224,
    batch_size: int = 256,
    force: bool = False,
    build_knn_graph: Optional[int] = None,
    limit: Optional[int] = None,
    mesh=None,
    tiling: str = "host",
    embedding=None,
):
    """Build `<ds>/indices/<index_name>` from the dataset's images on
    `device`, and return it loaded there.

    model_name resolves through `models.registry` (e.g. 'clip-vit-b32',
    'clip-vit-b32:<artifact dir>', 'hash-64') and is written into
    `info.json`; `embedding`, if given, encodes in its place (a model of
    that name in another dtype). With a `mesh`, the extraction is
    data-parallel over it. Optionally also builds the exact kNN graph with
    the given neighbour count on `device`."""
    if embedding is None:
        embedding = load_embedding(model_name, device)
    index_path = ds.index_path(index_name)
    index_cache.invalidate_prefix(str(index_path))  # rebuilds must not serve stale objects

    with transactional_folder(index_path, force=force) as tmp:
        vectors, dbidx, zoom, boxes = run_multiscale_extraction(
            ds, embedding,
            tile_size=tile_size, factor=factor, min_tile_size=min_tile_size,
            batch_size=batch_size, limit=limit, tiling=tiling, mesh=mesh,
        )
        meta, _ = VectorMeta.from_arrays(dbidx, zoom, boxes)  # already sorted
        MultiscaleIndex(device="cpu", vectors=vectors, meta=meta).save(tmp, model_name)

    # invalidate AFTER the commit too: a load in flight during the (long)
    # extraction finishes against the old folder and would re-memoize the
    # stale object past the pre-rebuild invalidation above
    index_cache.invalidate_prefix(str(index_path))
    idx = ds.load_index(index_name, device=device)
    if build_knn_graph:
        from ..knn_graph import KNNGraph

        KNNGraph.build(idx.vectors, n_neighbors=build_knn_graph, device=device).save(
            idx.get_knng_path("")
        )
    return idx


def infer_coarse_vectors(
    vectors: np.ndarray, dbidx: np.ndarray, zoom: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Whole-image vectors: mean of each image's most-zoomed-out tiles,
    renormalized."""
    out_dbidx = np.unique(dbidx)
    out = np.zeros((out_dbidx.shape[0], vectors.shape[1]), dtype=np.float32)
    for i, d in enumerate(out_dbidx):
        sel = dbidx == d
        zmax = zoom[sel].max()
        v = vectors[sel & (zoom == zmax)].mean(axis=0)
        out[i] = v / max(np.linalg.norm(v), 1e-6)
    return out, out_dbidx.astype(np.int32)


def create_coarse_index(ds, index_name: str, *, from_index: str, device,
                        force: bool = False):
    """Derive a coarse (one vector per image) index from a multiscale one,
    and return it loaded on `device`."""
    fine = ds.load_index(from_index, device=device)
    info_src = json.loads((Path(ds.index_path(from_index)) / "info.json").read_text())
    vecs, dbidx = infer_coarse_vectors(
        fine.vectors, fine.meta.dbidx, fine.meta.zoom_level
    )
    out_path = ds.index_path(index_name)
    index_cache.invalidate_prefix(str(out_path))
    with transactional_folder(out_path, force=force) as tmp:
        CoarseIndex(device="cpu", vectors=vecs, dbidx=dbidx).save(tmp, info_src.get("model", ""))
    index_cache.invalidate_prefix(str(out_path))  # see create_multiscale_index
    return ds.load_index(index_name, device=device)
