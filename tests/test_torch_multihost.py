"""The port's multi-process init and ingest fan-out against the JAX
package's (`tests/test_multihost.py`).

`ingest_file_range` partitions a corpus as the JAX function does, from
explicit arguments and from the process group. Two spawned CPU processes
join a gloo process group through `init_multihost` (explicit coordinator,
world size and rank), each contributes a (2, 8) slice of its rank + 1, and
an `all_reduce` of the slices' sums gives every process 16 + 32 = 48.0, the
JAX test's global psum. Exact: integer-valued f32 sums.
"""
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from seesaw_tpu.parallel.multihost import ingest_file_range as jax_range
from seesaw_tpu_torch.parallel.multihost import ingest_file_range


@pytest.mark.parametrize("n,hosts", [(1000003, 8), (3, 8), (10, 2), (64, 4), (0, 3)])
def test_ingest_file_range_matches_jax(n, hosts):
    ranges = [ingest_file_range(n, i, hosts) for i in range(hosts)]
    assert ranges == [jax_range(n, i, hosts) for i in range(hosts)]
    covered = [x for lo, hi in ranges for x in range(lo, hi)]
    assert covered == list(range(n))  # contiguous, disjoint, in order


_CHILD = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    from seesaw_tpu_torch.parallel.multihost import ingest_file_range, init_multihost

    n, rank = init_multihost({coord!r}, 2, int(sys.argv[1]), backend="gloo")
    assert (n, rank) == (2, int(sys.argv[1]))
    local = torch.full((2, 8), float(rank + 1))
    total = local.sum()
    dist.all_reduce(total)
    assert float(total) == 16.0 + 32.0, float(total)
    lo, hi = ingest_file_range(10)
    assert (lo, hi) == ((0, 5) if rank == 0 else (5, 10)), (lo, hi)
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "seesaw_tpu" not in sys.modules
    print(f"child {{rank}} ok")
    """
)


@pytest.mark.timeout(120)
def test_two_process_gloo_all_reduce(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = str(Path(__file__).resolve().parent.parent)
    f = tmp_path / "child.py"
    f.write_text(_CHILD.format(repo=repo, coord=f"127.0.0.1:{port}"))
    procs = [subprocess.Popen([sys.executable, str(f), str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=90)
            outs.append(out)
            assert p.returncode == 0, f"child {i} failed:\n{out}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert "child 0 ok" in outs[0] and "child 1 ok" in outs[1]
