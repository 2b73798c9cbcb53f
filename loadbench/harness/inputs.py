"""The benchmark's inputs, made from the seed: the tile index, the kNN graph,
the text queries and the simulated user's labels.

The index layout is the port's deployment bench (`seesaw_tpu_torch/utils/
rounds.py` `device_index` and `uniform_meta`, copied here): a frame-major
(N, D) matrix of random tile vectors made on the device in one call, 8 tiles
a frame in the box and zoom pattern of the configuration file, every tile
valid, frame f's dbidx f. bf16 values are standard normal; int8 values are
uniform in [-127, 127] with a scale per row uniform in [0.5, 1) / 127.

The graph is the forward kNN list of every row, in the pattern the
configuration's `graph` names (`window_local_graph` in `utils/rounds.py`,
after the JAX bench's `_make_window_local_edges`): each row draws `built_k`
neighbours, a `local_share` of them uniform within +-`window` rows of the
row and the rest uniform over all rows, never the row itself. Distances are
a function of the unordered pair, as in a metric space, so the two
directions of an edge agree; their RBF weights exp(-d / edist) at the
graph's `weight_edist` are uniform in [`weight_min`, 1.0), the JAX bench's
weights. Each row keeps the `knn_k` nearest of its distinct draws, by
ascending distance, as the loop's restriction to `knn_k` would: only those
are written. The draws come from the graph's own `draw` number and not from
the seed, so that every seed runs the same graph: its degrees set the padded
width the program's Jacobi kernel is tiled by, and with it the time of a
step. The seed relabels that graph by a cyclic shift of the row ids, which
keeps its locality: the same graph in another order.

Both the program and the reference are handed these same tensors.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on `device` seeded from `seed` (any whole number
    below 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of the seed."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


class IndexInputs:
    """The tile matrix and its layout, on the device: V (n, dim) in the
    storage type, row_scale (n,) f32 for int8 (None for bf16), boxes (n, 4)
    f32, zoom (n,) int32, valid (F, T) bool; and the host layout arrays the
    index's metadata is made of."""

    def __init__(self, cfg: dict, seed: int, device):
        dev = torch.device(device)
        T = int(cfg["tiles_per_frame"])
        F = int(cfg["n_tiles"]) // T
        n, D = F * T, int(cfg["dim"])
        g = generator(seed, dev)
        if cfg["storage"] == "int8":
            self.V = torch.randint(-127, 128, (n, D), dtype=torch.int8, device=dev, generator=g)
            self.row_scale = (torch.rand(n, device=dev, generator=g) * 0.5 + 0.5) / 127.0
        elif cfg["storage"] == "bfloat16":
            self.V = torch.randn(n, D, dtype=torch.bfloat16, device=dev, generator=g)
            self.row_scale = None
        else:
            raise ValueError(f"unknown storage {cfg['storage']!r}")
        self.tile_boxes = np.asarray(cfg["tile_boxes"], dtype=np.float32)  # (T, 4)
        self.tile_zoom = np.asarray(cfg["tile_zoom"], dtype=np.int32)  # (T,)
        if self.tile_boxes.shape != (T, 4) or self.tile_zoom.shape != (T,):
            raise ValueError("tile_boxes / tile_zoom do not match tiles_per_frame")
        self.n_frames, self.tiles, self.dim = F, T, D
        self.boxes = torch.from_numpy(self.tile_boxes).to(dev).repeat(F, 1)
        self.zoom = torch.from_numpy(self.tile_zoom).to(dev).repeat(F)
        self.valid = torch.ones(F, T, dtype=torch.bool, device=dev)

    @property
    def n(self) -> int:
        return self.n_frames * self.tiles

    def index_bytes(self) -> int:
        """Bytes a scan of the whole matrix reads: the vectors and, for int8,
        the per-row scales."""
        b = self.V.numel() * self.V.element_size()
        if self.row_scale is not None:
            b += self.row_scale.numel() * self.row_scale.element_size()
        return b


def vector_meta(inputs: IndexInputs):
    """The port's host metadata of the layout (`utils/rounds.py`
    `uniform_meta`): frame f's dbidx f, its tiles rows [f*T, (f+1)*T)."""
    from seesaw_tpu_torch.indices.meta import VectorMeta

    F, T = inputs.n_frames, inputs.tiles
    return VectorMeta(
        dbidx=np.repeat(np.arange(F, dtype=np.int32), T),
        zoom_level=np.tile(inputs.tile_zoom, F),
        boxes=np.tile(inputs.tile_boxes, (F, 1)),
        frame_dbidx=np.arange(F, dtype=np.int32),
        frame_starts=np.arange(0, (F + 1) * T, T, dtype=np.int32),
        frame_id=np.repeat(np.arange(F, dtype=np.int32), T),
    )


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 63-bit integer hash (splitmix64's finaliser, with logical shifts)."""
    x = x & _MASK63
    x = ((x ^ (x >> 30)) * -4658895280553007687) & _MASK63  # 0xbf58476d1ce4e5b9
    x = ((x ^ (x >> 27)) * -7723592293110705685) & _MASK63  # 0x94d049bb133111eb
    return (x ^ (x >> 31)) & _MASK63


def pair_distance(a: torch.Tensor, b: torch.Tensor, n: int, seed: int, edist: float,
                  weight_min: float):
    """The distance of the unordered pair (a, b): -edist * ln(u) with u
    uniform in [weight_min, 1) drawn from a hash of the pair and the seed, so
    that its RBF weight exp(-d / edist) is u."""
    lo, hi = torch.minimum(a, b).to(torch.int64), torch.maximum(a, b).to(torch.int64)
    salt = int(_mix(torch.tensor([int(seed) % (1 << 63)], dtype=torch.int64))[0])
    h = _mix((lo * n + hi) ^ salt)
    u = (h >> 11).to(torch.float64) / float(1 << 52) * (1.0 - weight_min) + weight_min
    return (-edist * torch.log(u)).to(torch.float32)


GRAPH_BLOCK_ROWS = 1 << 20  # the draws are made a block at a time, in this order


def knn_graph(n: int, graph: dict, k: int, seed: int, device):
    """(dst (n, k) int32, dist (n, k) f32) on `device`: each row's k
    nearest neighbours, nearest first, in the pattern of the configuration's
    `graph` (see the module docstring), drawn from its `draw` and shifted by
    `graph_shift(seed, n)` rows. Made in blocks of `GRAPH_BLOCK_ROWS` rows,
    so that the `built_k` draws of a block are all that is held at once."""
    built_k, window = int(graph["built_k"]), int(graph["window"])
    draw = int(graph["draw"])
    local_share, edist = float(graph["local_share"]), float(graph["weight_edist"])
    weight_min = float(graph["weight_min"])
    if not 1 <= k <= built_k or n < 2:
        raise ValueError(f"cannot keep {k} of {built_k} neighbours of {n} rows")
    dev = torch.device(device)
    g = generator(draw + 1, dev)
    dst = torch.empty(n, k, dtype=torch.int32, device=dev)
    dist = torch.empty(n, k, dtype=torch.float32, device=dev)
    for r0 in range(0, n, GRAPH_BLOCK_ROWS):
        m = min(GRAPH_BLOCK_ROWS, n - r0)
        rows = torch.arange(r0, r0 + m, dtype=torch.int64, device=dev)[:, None]
        off = torch.randint(1, window + 1, (m, built_k), device=dev, generator=g)
        off = torch.where(torch.rand(m, built_k, device=dev, generator=g) < 0.5, -off, off)
        local = rows + off
        local = torch.where((local < 0) | (local >= n), rows - off, local).clamp_(0, n - 1)
        local = torch.where(local == rows, (rows + 1) % n, local)  # a window wider than n
        far = torch.randint(0, n - 1, (m, built_k), device=dev, generator=g)
        far = far + (far >= rows).to(far.dtype)  # every row but the row itself
        near = torch.rand(m, built_k, device=dev, generator=g) < local_share
        cand = torch.where(near, local, far)
        d = pair_distance(rows.expand(m, built_k), cand, n, draw, edist, weight_min)
        d, order = torch.sort(d, dim=1, stable=True)
        cand = torch.gather(cand, 1, order)
        # a neighbour drawn twice has one distance, so its repeats lie side by
        # side: they go behind every distinct neighbour
        again = torch.zeros_like(near)
        again[:, 1:] = cand[:, 1:] == cand[:, :-1]
        order = torch.sort(again.to(torch.int8), dim=1, stable=True).indices[:, :k]
        dst[r0:r0 + m] = torch.gather(cand, 1, order).to(torch.int32)
        dist[r0:r0 + m] = torch.gather(d, 1, order)
    shift = graph_shift(seed, n)
    dst = torch.roll((dst.to(torch.int64) + shift) % n, shift, dims=0).to(torch.int32)
    return dst, torch.roll(dist, shift, dims=0)


def graph_shift(seed: int, n: int) -> int:
    """The rows by which the seed shifts the graph's ids: row i's list
    becomes row (i + shift) % n's, and each id j in it (j + shift) % n."""
    return int(host_rng(seed, 4).integers(n))


def write_forward_parquet(path, dst: np.ndarray, dist: np.ndarray) -> int:
    """Write the graph as the port reads it (`KNNGraph.from_file`):
    `forward.parquet` with (src_vertex, dst_vertex, distance, dst_rank)
    rows sorted by source and rank, a rank-0 self edge first in each row.
    Returns the bytes written."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    n, k = dst.shape
    src = np.repeat(np.arange(n, dtype=np.int32), k + 1)
    dsts = np.concatenate([np.arange(n, dtype=np.int32)[:, None], dst], axis=1).reshape(-1)
    dists = np.concatenate([np.zeros((n, 1), np.float32), dist], axis=1).reshape(-1)
    rank = np.tile(np.arange(k + 1, dtype=np.int32), n)
    table = pa.table({"src_vertex": src, "dst_vertex": dsts, "distance": dists,
                      "dst_rank": rank})
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "forward.parquet")
    pq.write_table(table, out)
    return os.path.getsize(out)


def query_vector(seed: int, user: int, session: int, dim: int) -> np.ndarray:
    """The text query of a user's session: a seeded random unit vector (the
    text tower's output in a deployment)."""
    v = host_rng(seed, 1, user, session).normal(size=dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def accept_schedule(seed: int, user: int, session: int, clicks: int, batch: int,
                    found: int) -> np.ndarray:
    """Whether the simulated user accepts each image a session of `clicks`
    clicks shows: exactly `found` of them, one in the last click and the
    rest among the earlier images, at places drawn from the seed; so the
    session finds its `found`-th result in its last click."""
    before = (clicks - 1) * batch
    if not 1 <= found <= before + 1:
        raise ValueError(f"{found} results cannot be found in {clicks} clicks")
    rng = host_rng(seed, 2, user, session)
    out = np.zeros(clicks * batch, dtype=bool)
    out[rng.choice(before, found - 1, replace=False)] = True
    out[before + rng.integers(batch)] = True
    return out
