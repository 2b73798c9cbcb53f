"""PyTorch counterparts of seesaw_tpu.ops on the serving path."""
import threading

_launch_lock = threading.Lock()


def count_launch(wrapper, dtype_key=None):
    """Add one to a kernel wrapper's `launches` (and to its
    `launches_by_dtype[dtype_key]` when given) under one process-wide lock:
    server threads launch kernels concurrently, and `+=` on an attribute is
    a read-modify-write that can lose counts."""
    with _launch_lock:
        wrapper.launches += 1
        if dtype_key is not None:
            wrapper.launches_by_dtype[dtype_key] += 1
