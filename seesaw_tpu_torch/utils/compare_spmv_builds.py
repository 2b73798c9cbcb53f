"""Time several builds of the kNN SpMV / Jacobi source on one card, in one
process, so that a change and its parent are compared on the same card.

    git show HEAD~1:seesaw_tpu_torch/csrc/knn_spmv.cu > build/parent_knn_spmv.cu
    python -m seesaw_tpu_torch.utils.compare_spmv_builds \\
        build/parent_knn_spmv.cu seesaw_tpu_torch/csrc/knn_spmv.cu

Each source is compiled with nvcc (the flags of `_build`, plus `-Xptxas -v`,
whose report goes beside the library,
`build/seesaw_tpu_torch/compare_spmv_<i>.ptxas.txt`; the registers and
shared memory of `jacobi_kernel<32>` and `spmv_kernel<32>` are printed). To
time another value of a compile-time constant, edit it in a copy of the
source and pass both. The libraries are loaded with ctypes and run on a
10M x 32 window-local graph (`rounds.window_local_graph`, the main path's)
and on a uniform graph of the same size (`rounds.uniform_graph`), the
builds taken in turns (a, b, ..., b, a):

- W f (`seesaw_knn_spmv`): CUDA-event ms, error against the plain version;
- one Jacobi step (a segment of one step, eps 0): CUDA-event and device ms,
  error against the plain version, whether a rerun gives the same bits;
- a 100-step segment whose run converges at its third step
  (`rounds.segment_ms`): device ms, host ms, launches, and its steps and
  done flag against the plain version's.

A source whose `seesaw_jacobi_step` takes no step count (from before the
one-launch segment) is driven as its wrapper drove it, one launch a step,
so that the change that brought the segment is timed against its parent.
One line per graph and build on standard output. Needs a CUDA device;
imports no JAX.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build
from ..ops import spmv
from . import rounds as R
from .profiling import card_line, cuda_ms, device_ms

P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
N, K = 10_000_000, 32  # chip_smoke.py's main path
SPMV_TOL = dict(rtol=2e-5, atol=2e-6)  # chip_smoke.py's bar for W f and the step


def build(paths):
    """[(name, library, whether its Jacobi entry takes a step count)], one
    nvcc each, started together."""
    procs = []
    for i, path in enumerate(paths):
        so = _build.BUILD_DIR / f"compare_spmv_{i}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        text = Path(path).read_text()
        sig = text[text.index('extern "C" int seesaw_jacobi_step('):]
        takes_steps = "int steps" in sig[:sig.index("{")]
        procs.append((f"{i}:{Path(path).stem}", so, takes_steps, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, so, takes_steps, proc in procs:
        report, _ = proc.communicate()
        so.with_suffix(".ptxas.txt").write_text(report)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report[-3000:]}")
        for kernel in ("jacobi_kernelILi32E", "spmv_kernelILi32E"):
            m = re.search(kernel + r".*?\n(?:.*\n)*?.*?(Used \d+ registers[^\n]*)", report)
            print(f"{name} {kernel[:-5]}<32>: {m.group(1) if m else 'not in the report'}")
        libs.append((name, ctypes.CDLL(str(so)), takes_steps))
    return libs


def entries(lib, takes_steps):
    """(W f, Jacobi segment) callables over torch tensors for one build; the
    segment counts its launches in its own `launches`."""
    spmv_c, jac = lib.seesaw_knn_spmv, lib.seesaw_jacobi_step
    spmv_c.argtypes, spmv_c.restype = [P, P, P, P, L, I, P], I
    jac.argtypes = [P] * 9 + ([F, L, I, I, P] if takes_steps else [F, L, I, P])
    jac.restype = I

    def wf(f, nbr, w):
        out = torch.empty_like(f)
        err = spmv_c(f.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
                     nbr.shape[0], nbr.shape[1], torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out

    def segment(fa, fb, nbr, w, denom, lam_prior, labels, is_labeled, state, eps, steps=1):
        n, k = nbr.shape
        rest = [t.data_ptr() for t in (nbr, w, denom, lam_prior, labels, is_labeled, state)]
        stream = torch.cuda.current_stream().cuda_stream
        if takes_steps:
            calls = [(fa, fb, steps)]
        else:  # one launch a step, buffers swapped as the step count's parity
            calls = [((fa, fb)[s % 2], (fb, fa)[s % 2]) for s in range(steps)]
        for call in calls:
            err = jac(call[0].data_ptr(), call[1].data_ptr(), *rest, eps, n, k,
                      *call[2:], stream)
            assert err == 0, err
            segment.launches += 1

    segment.launches = 0
    return wf, segment


def compare_graph(name, nbr, w, degree, libs, gen):
    dev = nbr.device
    n = nbr.shape[0]
    f = torch.rand(n, device=dev, generator=gen)
    prior = torch.rand(n, device=dev, generator=gen)
    labels = (torch.rand(n, device=dev, generator=gen) < 0.3).float()
    is_labeled = torch.rand(n, device=dev, generator=gen) < 0.01
    step_args = (nbr, w, degree + 1.0, prior, labels, is_labeled)  # lambda = 1
    wfs = [(torch.rand(n, device=dev, generator=gen), nbr, w) for _ in range(10)]
    bufs = (f.clone(), torch.empty_like(f))  # the timed steps overwrite these
    steps = [(bufs[i % 2], bufs[(i + 1) % 2], *step_args, spmv.new_state(dev), 0.0)
             for i in range(10)]
    want_wf = spmv.knn_spmv_plain(*wfs[0])
    want_step = torch.empty_like(f)
    spmv.jacobi_step_plain(f, want_step, *step_args, spmv.new_state(dev), 0.0)
    seg_eps = R.converging_eps(f, step_args)
    want_seg = spmv.new_state(dev)
    spmv.jacobi_step_plain(f.clone(), torch.empty_like(f), *step_args, want_seg, seg_eps,
                           R.SEGMENT_STEPS)
    want_seg = want_seg[[spmv.ITERS, spmv.DONE]].tolist()

    res = {}
    for bname, lib, takes_steps in libs:
        wf, segment = entries(lib, takes_steps)
        outs = []
        for _ in range(2):
            out = torch.empty_like(f)
            segment(f, out, *step_args, spmv.new_state(dev), 0.0)
            outs.append(out)
        torch.cuda.synchronize()
        res[bname] = dict(
            wf_err=float((wf(*wfs[0]) - want_wf).abs().max()),
            step_err=float((outs[0] - want_step).abs().max()),
            step_ok=bool(torch.allclose(outs[0], want_step, **SPMV_TOL)),
            rerun_same=bool(torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))),
            step_device_ms=device_ms(segment, steps), wf_ms=[], step_ms=[], seg=[])
    for bname, lib, takes_steps in [*libs, *reversed(libs)]:
        wf, segment = entries(lib, takes_steps)
        r = res[bname]
        r["wf_ms"].append(cuda_ms(wf, wfs))
        r["step_ms"].append(cuda_ms(segment, steps))
        seg = R.segment_ms(segment, f, step_args, seg_eps)
        del seg["out"]
        r["seg"].append(seg)
    for bname, r in res.items():
        seg = r["seg"]
        got = [[s["steps"], s["done"]] for s in seg]
        print(f"{name} N={n} Kp={nbr.shape[1]} {bname}: "
              f"knn_spmv_ms={sum(r['wf_ms']) / len(r['wf_ms'])!r} "
              f"knn_spmv_err={r['wf_err']!r} "
              f"step_events_ms={sum(r['step_ms']) / len(r['step_ms'])!r} "
              f"step_device_ms={r['step_device_ms']!r} step_err={r['step_err']!r} "
              f"step_within_bar={r['step_ok']} bit_identical_rerun={r['rerun_same']} "
              f"segment_of_{R.SEGMENT_STEPS}: steps_done={got[0]} plain={want_seg} "
              f"all_runs_as_plain={all(g == want_seg for g in got)} "
              f"launches={seg[0]['launches']} "
              f"device_ms={sum(s['device_ms'] or 0 for s in seg) / len(seg)!r} "
              f"host_ms={sum(s['host_ms'] for s in seg) / len(seg)!r}", flush=True)


def main(paths) -> int:
    if not torch.cuda.is_available():
        print("compare_spmv_builds: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line())
    libs = build(paths)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = R.window_local_graph(N, K, dev, gen)
    compare_graph("window-local", g.nbr, g.w, g.degree, libs, gen)
    del g
    torch.cuda.empty_cache()
    compare_graph("uniform", *R.uniform_graph(N, K, dev, gen), libs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
