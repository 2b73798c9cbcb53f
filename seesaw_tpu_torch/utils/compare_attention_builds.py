"""Time several builds of the f32 pair-attention source on one card, in one
process, so that a change and its parent are compared on the same card.

    git show HEAD~1:seesaw_tpu_torch/csrc/pair_attention.cu > build/parent.cu
    python -m seesaw_tpu_torch.utils.compare_attention_builds \\
        build/parent.cu seesaw_tpu_torch/csrc/pair_attention.cu

Each source is compiled with nvcc (the flags of `_build`, plus `-Xptxas -v`,
whose report goes beside the library, `build/seesaw_tpu_torch/
compare_<name>.ptxas.txt`), loaded with ctypes and
run at every f32 case of `chip_smoke.py`'s ATTN_CASES (K5) and BWD_CASES
(K6): its error against the plain version (f32 bar rtol 1e-5 / atol 1e-5),
whether two runs give the same bits, its device time (`profiling.device_ms`)
and its CUDA-event time, the builds taken in turns (a, b, ..., b, a). One
line a case on standard output. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build
from ..ops import attention as A
from .profiling import card_line, cuda_ms, device_ms

ROOT = Path(__file__).resolve().parents[2]
P, I = ctypes.c_void_p, ctypes.c_int


def build(paths):
    """name -> loaded library, one nvcc each, started together."""
    procs = {}
    for path in paths:
        name = Path(path).stem
        so = _build.BUILD_DIR / f"compare_{name}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report, _ = proc.communicate()
        so.with_suffix(".ptxas.txt").write_text(report)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report[-3000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, kind, causal):
    """A call of the build's forward or backward entry on (B, L, W) f32 tensors."""
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "fwd":
        f = lib.seesaw_pair_attention
        f.argtypes, f.restype = [P] * 4 + [I] * 4 + [P], I

        def run(q, k, v):
            B, L, W = q.shape
            out = torch.empty_like(q)
            err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, W // 64,
                    int(causal), stream)
            assert err == 0, err
            return (out,)
        return run
    f = lib.seesaw_pair_attention_bwd
    f.argtypes, f.restype = [P] * 8 + [I] * 4 + [P], I

    def run(q, k, v, g):
        B, L, W = q.shape
        grads = [torch.empty_like(q) for _ in range(3)]
        stats = torch.empty(3, B * (W // 64) * L, device=q.device)
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                *(t.data_ptr() for t in grads), stats.data_ptr(), B, L, W // 64, int(causal),
                stream)
        assert err == 0, err
        return tuple(grads)
    return run


def main(paths) -> int:
    if not torch.cuda.is_available():
        print("compare_attention_builds: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    libs = build(paths)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = ([("fwd", *c[:5]) for c in CS.ATTN_CASES if c[5] == "float32"]
             + [("bwd", *c) for c in CS.BWD_CASES])
    for kind, name, B, L, W, causal in cases:
        sets = [[torch.randn(B, L, W, device=dev, generator=gen)
                 for _ in range(3 if kind == "fwd" else 4)] for _ in range(5)]
        want = (A.pair_attention_plain(*sets[0], causal=causal),) if kind == "fwd" else \
            A.pair_attention_bwd_plain(*sets[0], causal=causal)
        res = {}
        for n, lib in libs.items():
            fn = entry(lib, kind, causal)
            got, again = fn(*sets[0]), fn(*sets[0])
            torch.cuda.synchronize()
            res[n] = dict(
                err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
                ok=all(torch.allclose(a, b, rtol=1e-5, atol=1e-5) for a, b in zip(got, want)),
                same=all(torch.equal(a, b) for a, b in zip(got, again)),
                dev=device_ms(fn, sets), ev=[])
        for n in [*libs, *reversed(libs)]:
            res[n]["ev"].append(cuda_ms(entry(libs[n], kind, causal), sets * 4))
        print(f"{kind} {name} B={B} L={L} W={W} causal={causal}: " + "; ".join(
            f"{n} device_ms={r['dev']!r} events_ms={sum(r['ev']) / len(r['ev'])!r} "
            f"max_abs_err={r['err']!r} within_bar={r['ok']} bit_identical_rerun={r['same']}"
            for n, r in res.items()), flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
