"""The kernel wrappers' launch counters hold under threads: server threads
launch kernels concurrently, and every count goes through one lock
(`seesaw_tpu_torch.ops.count_launch`)."""
import sys
import threading

from seesaw_tpu_torch.ops import attention, count_launch, fused_scoring, spmv

THREADS, PER_THREAD = 8, 20_000


def _hammer(fn):
    start = threading.Barrier(THREADS)

    def worker():
        start.wait()
        for _ in range(PER_THREAD):
            fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        threads = [threading.Thread(target=worker) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_counts_from_eight_threads_are_exact():
    wrappers = (fused_scoring.fused_frame_max, spmv.knn_spmv, spmv.jacobi_step)
    before = [w.launches for w in wrappers]

    def launch_all():
        for w in wrappers:
            count_launch(w)

    _hammer(launch_all)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [THREADS * PER_THREAD] * 3


def test_per_dtype_counts_from_eight_threads_are_exact():
    attention.reset_launch_counts()
    try:
        _hammer(lambda: attention._count(attention.pair_attention, "torch.bfloat16"))
        assert attention.pair_attention.launches == THREADS * PER_THREAD
        assert attention.pair_attention.launches_by_dtype == {
            "float32": 0, "bfloat16": THREADS * PER_THREAD}
    finally:
        attention.reset_launch_counts()
