"""The chip's peaks and the work of each device operation the clicks need,
counted from shapes by the benchmark's own code, whatever implements it.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, no sparsity),
at its full 700 W power limit.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_FLOPS = {  # per second
    "float32": 67e12,  # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "int8": 1979e12,
}


def least_seconds(nbytes: float, flops: float = 0.0, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the type's peak, whichever is larger."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def scan_work(index_bytes: int, n: int, dim: int, queries: int, dtype: str):
    """(bytes, flops, dtype) of one scan of the index for `queries` queries
    at once: the matrix read once, 2 * n * dim operations a query, and for a
    batch the (n, queries) f32 scores written, which its ranking tail reads
    (a solo scan keeps only a maximum a frame, left out as negligible)."""
    out = 4 * n * queries if queries > 1 else 0
    return index_bytes + out, 2.0 * n * dim * queries, dtype


def jacobi_step_bytes(n: int, edges: int) -> int:
    """Bytes one Jacobi step over the symmetric graph needs: each stored
    edge's neighbour id (int32) and weight (f32) read once, and per row the
    iterate read and written, the denominator, the prior term and the label
    (f32 each) and the labelled flag (one byte)."""
    return 8 * edges + 21 * n


def share(least_s: float, measured_s: float) -> float | None:
    """Percent of the roofline: least time over measured time; None where
    nothing was measured."""
    if measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
