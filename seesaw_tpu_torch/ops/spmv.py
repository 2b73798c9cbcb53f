"""kNN SpMV and the Jacobi step of label propagation.

Counterpart of the SpMV of `seesaw_tpu/ops/pallas_spmv.py` (`windowed_spmv`:
the Pallas kernels `_spmv_kernel`, `_lane_gather_mul_kernel` and
`_onehot_reduce_kernel`) and of the step inside
`seesaw_tpu/ops/propagation.py::_propagate_segment`. Both compute

    wf[i] = sum_{k : nbr[i, k] >= 0} w[i, k] * f[nbr[i, k]]

over the graph's own (N, Kp) arrays. On a CUDA tensor each wrapper launches
the hand-written kernel in `csrc/knn_spmv.cu` or raises; on a CPU tensor it
runs its plain PyTorch version beside it. `knn_spmv(row_block=True)` takes
R rows of a row-sharded graph with global column ids over the whole
gathered f (the mesh's propagation, `parallel.sharded_graph`): the kernel
gathers f by column id and sizes its grid by the row count, so the form
needs no other source.

The TPU's windowed layout (int16 lane slabs, window selection, RCM
relabeling, routed overflow) exists to feed a lane shuffle in VMEM and is not
carried over: on the card every edge is a slot of its row, and the Jacobi
kernel gathers from a window of f in shared memory where the graph has
locality and from L2 elsewhere.

A Jacobi run keeps its state in a small int32 device tensor (`new_state`):
the max-delta scratch, the done flag, the number of executed steps and the
kernel's grid barrier. A whole segment of steps (one `jacobi_step` call
with `steps`) is one kernel launch on the card, which decides after each
step whether the run is done and skips the rest; the caller reads (steps,
done) once a segment.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import kernel_launch
from . import count_launch

DONE, ITERS = 1, 2  # state words read by callers (see csrc/knn_spmv.cu)


def new_state(device) -> torch.Tensor:
    """Fresh Jacobi state: not done, no steps executed."""
    return torch.zeros(4, dtype=torch.int32, device=device)


_lib = None


def _library():
    """The built `csrc/knn_spmv.cu` (nvcc at first use), with the C
    signatures of its two entry points set."""
    global _lib
    if _lib is None:
        from .._build import load_library

        lib = load_library("knn_spmv")
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.seesaw_knn_spmv.argtypes = [P, P, P, P, L, I, P]
        lib.seesaw_jacobi_step.argtypes = [P, P, P, P, P, P, P, P, P, F, L, I, I, P]
        lib.seesaw_knn_spmv.restype = lib.seesaw_jacobi_step.restype = I
        _lib = lib
    return _lib


def _check_graph(f, nbr, w, *, row_block: bool = False):
    """A graph (N, Kp) over f (N,); with `row_block`, R rows of a sharded
    graph with global column ids over the whole (gathered) f, R <= len(f)."""
    if nbr.dim() != 2 or w.shape != nbr.shape or f.dim() != 1:
        raise ValueError(
            f"expected nbr, w (N, Kp) and f (N,): got nbr {tuple(nbr.shape)}, "
            f"w {tuple(w.shape)}, f {tuple(f.shape)}"
        )
    if f.shape[0] < nbr.shape[0] or (f.shape[0] != nbr.shape[0] and not row_block):
        raise ValueError(f"f has {f.shape[0]} rows, the graph {nbr.shape[0]}")
    if nbr.dtype != torch.int32 or w.dtype != torch.float32 or f.dtype != torch.float32:
        raise TypeError("nbr must be int32, w and f float32")


def _check_device(tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    return dev


def knn_spmv_plain(f: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor, *,
                   row_block: bool = False) -> torch.Tensor:
    """Plain PyTorch version: gather, multiply, row sum; -1 slots count 0."""
    _check_graph(f, nbr, w, row_block=row_block)
    gathered = torch.where(nbr >= 0, f[nbr.clamp(min=0).long()], 0.0)
    return (w * gathered).sum(dim=1)


def knn_spmv(f: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor, *,
             row_block: bool = False) -> torch.Tensor:
    """(N,) f32 W f. f (N,) f32; nbr (N, Kp) int32 with -1 padding; w (N, Kp)
    f32. With `row_block`, nbr and w are R rows of a row-sharded graph
    whose column ids index the whole gathered f (R <= len(f)), and the
    result is those rows' (R,) sums: the kernel gathers f by column id and
    sizes its grid by the row count. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if f.device.type == "cpu":
        return knn_spmv_plain(f, nbr, w, row_block=row_block)
    _check_graph(f, nbr, w, row_block=row_block)
    dev = _check_device([f, nbr, w])
    fn = _library().seesaw_knn_spmv
    out = torch.empty(nbr.shape[0], dtype=torch.float32, device=dev)
    with kernel_launch("ops.knn_spmv"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(f.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
                 nbr.shape[0], nbr.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"knn_spmv kernel launch failed: CUDA error {err}")
    count_launch(knn_spmv)
    return out


knn_spmv.launches = 0  # kernel launches in this process (CUDA only)


def _check_step(f_in, f_out, nbr, w, denom, lam_prior, labels, is_labeled, state, steps):
    _check_graph(f_in, nbr, w)
    n = f_in.shape[0]
    for name, t in (("f_out", f_out), ("denom", denom), ("lam_prior", lam_prior),
                    ("labels", labels)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 of shape ({n},)")
    if is_labeled.shape != (n,) or is_labeled.dtype != torch.bool:
        raise ValueError(f"is_labeled must be bool of shape ({n},)")
    if state.shape != (4,) or state.dtype != torch.int32:
        raise ValueError("state must be int32 of shape (4,) (new_state)")
    if f_out.data_ptr() == f_in.data_ptr():
        raise ValueError("f_in and f_out must be distinct buffers")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")


def jacobi_step_plain(f_in, f_out, nbr, w, denom, lam_prior, labels, is_labeled,
                      state, eps: float, steps: int = 1) -> None:
    """Plain PyTorch version, with the kernel's semantics and no host read:
    each step writes step(src) into the other buffer of (f_in, f_out) unless
    the run is done, then sets state[done] = max((new - src)^2) < eps (False
    for a NaN max) and adds 1 to state[iters]."""
    _check_step(f_in, f_out, nbr, w, denom, lam_prior, labels, is_labeled, state, steps)
    bufs = (f_in, f_out)
    for k in range(steps):
        src, dst = bufs[k % 2], bufs[(k + 1) % 2]
        new_f = torch.where(is_labeled, labels, (knn_spmv_plain(src, nbr, w) + lam_prior) / denom)
        delta = ((new_f - src) ** 2).max()
        done = state[DONE] != 0
        dst.copy_(torch.where(done, dst, new_f))
        state[DONE] = torch.where(done, state[DONE], (delta < eps).to(torch.int32))
        state[ITERS] = state[ITERS] + (~done).to(torch.int32)


def jacobi_step(f_in, f_out, nbr, w, denom, lam_prior, labels, is_labeled,
                state, eps: float, steps: int = 1) -> None:
    """`steps` Jacobi steps over the buffer pair (f_in, f_out), step k reading
    buffer k % 2 and writing the other (one step: f_in -> f_out):

        new = is_labeled ? labels : (W src + lam_prior) / denom

    A step is skipped once `state` says the run is done; otherwise it sets
    the done flag when max((new - src)^2) < eps and adds 1 to the step count.
    All tensors (N,) f32 except nbr (N, Kp) int32, w (N, Kp) f32, is_labeled
    (N,) bool and state (`new_state`). The inputs are checked once for all
    the steps. CPU tensors take the plain version; CUDA tensors launch the
    kernel once for the whole segment, or raise."""
    if f_in.device.type == "cpu":
        return jacobi_step_plain(f_in, f_out, nbr, w, denom, lam_prior, labels,
                                 is_labeled, state, eps, steps)
    _check_step(f_in, f_out, nbr, w, denom, lam_prior, labels, is_labeled, state, steps)
    tensors = [f_in, f_out, nbr, w, denom, lam_prior, labels, is_labeled, state]
    dev = _check_device(tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("jacobi_step needs 16-byte aligned inputs (its bulk copies)")
    fn = _library().seesaw_jacobi_step
    with kernel_launch("ops.jacobi_step", steps=int(steps)), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), float(eps), nbr.shape[0], nbr.shape[1],
                 int(steps), stream)
    if err != 0:
        raise RuntimeError(f"jacobi_step kernel launch failed: CUDA error {err}")
    count_launch(jacobi_step)


jacobi_step.launches = 0  # kernel launches in this process (CUDA only)
