"""The port's kNN SpMV and Jacobi step (`seesaw_tpu_torch.ops.spmv`) against
the JAX package on the same numpy inputs, on the CPU: the plain versions
against `windowed_spmv` (the Pallas kernels K2-K4, in interpret mode) with a
scalar-overflow layout and with a routed-overflow layout, and one Jacobi
step against the step of `_propagate_segment`. The CUDA kernel is compared
with the plain version by the `cuda`-marked tests (skipped without a GPU)
and by chip_smoke.py: one launch a segment, whatever its length, equal to
the plain version's steps, with the same bits on a rerun.

Tolerances: SpMV rtol 2e-5 / atol 2e-6, the JAX package's own bar between
its windowed and dense SpMV (f32 sums in another order); the Jacobi step
the same on the scores, and the done flag and step count equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seesaw_tpu.ops.pallas_spmv import build_windowed_layout, windowed_spmv, with_routed_overflow
from seesaw_tpu.ops.propagation import _propagate_segment
from seesaw_tpu_torch.ops import spmv

TOL = dict(rtol=2e-5, atol=2e-6)


def _graph(n, K, seed, local_frac=0.8, spread=64):
    """Mostly near-diagonal neighbours plus some uniform ones, -1 padding."""
    rng = np.random.default_rng(seed)
    base = np.arange(n)[:, None]
    local = np.clip(base + rng.integers(-spread, spread + 1, size=(n, K)), 0, n - 1)
    rand = rng.integers(0, n, size=(n, K))
    nbr = np.where(rng.random((n, K)) < local_frac, local, rand).astype(np.int32)
    nbr[7, 3:] = -1
    nbr[11, :] = -1  # an isolated row
    w = rng.uniform(0.1, 1.0, size=(n, K)).astype(np.float32)
    w[nbr < 0] = 0.0
    return nbr, w


def _jax_spmv(layout, f):
    return np.asarray(windowed_spmv(
        jnp.asarray(f), jnp.asarray(layout.cidx), jnp.asarray(layout.wslab),
        jnp.asarray(layout.ovf_src), jnp.asarray(layout.ovf_nbr),
        jnp.asarray(layout.ovf_w), layout.routed_arrays(),
        n=layout.n, B=layout.B, W=layout.W, cap=layout.cap, interpret=True,
    ))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_knn_spmv_matches_windowed_scalar_overflow():
    nbr, w = _graph(2000, 8, seed=0)
    layout = build_windowed_layout(nbr, w, B=128, W=256, cap=4)
    assert layout.routed is None and layout.coverage < 1.0  # overflow served by COO
    f = np.random.default_rng(1).uniform(0, 1, 2000).astype(np.float32)
    got = spmv.knn_spmv(_t(f), _t(nbr), _t(w)).numpy()
    np.testing.assert_allclose(got, _jax_spmv(layout, f), **TOL)
    assert got[11] == 0.0


def test_knn_spmv_matches_windowed_routed_overflow():
    """No locality plus a hub: most edges go to the routed overflow that K3
    and K4 serve on the TPU."""
    n, K = 3000, 8
    rng = np.random.default_rng(11)
    nbr = rng.integers(0, n, size=(n, K)).astype(np.int32)
    nbr[:, 0] = 5  # hub: vertex 5 is everyone's neighbour
    nbr[17, 3:] = -1
    w = rng.uniform(0.1, 1.0, size=(n, K)).astype(np.float32)
    w[nbr < 0] = 0.0
    layout = with_routed_overflow(build_windowed_layout(nbr, w, B=128, W=256, cap=4),
                                  min_edges=1)
    assert layout.routed is not None and layout.coverage < 0.6
    f = rng.uniform(0, 1, n).astype(np.float32)
    got = spmv.knn_spmv(_t(f), _t(nbr), _t(w)).numpy()
    np.testing.assert_allclose(got, _jax_spmv(layout, f), **TOL)


def _step_inputs(seed, n=600, K=6, lam=1.0, nan_row=None):
    rng = np.random.default_rng(seed)
    nbr, w = _graph(n, K, seed)
    degree = w.sum(axis=1).astype(np.float32)
    degree[11] = 0.0
    prior = rng.uniform(0.05, 0.95, n).astype(np.float32)
    if nan_row is not None:
        prior[nan_row] = np.nan
    labels = (rng.random(n) < 0.5).astype(np.float32)
    is_labeled = rng.random(n) < 0.05
    f = np.where(is_labeled, labels, rng.uniform(0, 1, n)).astype(np.float32)
    return dict(nbr=nbr, w=w, degree=degree, prior=prior, labels=labels,
                is_labeled=is_labeled, f=f, lam=lam)


def _port_step(d, eps, state=None, lam=None):
    lam = d["lam"] if lam is None else lam
    denom = d["degree"] + np.float32(lam)
    denom = np.where(denom > 0, denom, np.float32(1.0)).astype(np.float32)
    f_out = torch.full((d["f"].shape[0],), 7.0)
    state = spmv.new_state("cpu") if state is None else state
    spmv.jacobi_step(_t(d["f"]), f_out, _t(d["nbr"]), _t(d["w"]), _t(denom),
                     np.float32(lam) * _t(d["prior"]), _t(d["labels"]),
                     _t(d["is_labeled"]), state, eps)
    return f_out.numpy(), state


def _jax_step(d, eps):
    f = jnp.asarray(d["f"])
    new_f, _, i, done, _ = _propagate_segment(
        jnp.asarray(d["nbr"]), jnp.asarray(d["w"]), jnp.asarray(d["degree"]),
        jnp.asarray(d["prior"]), jnp.asarray(d["labels"]), jnp.asarray(d["is_labeled"]),
        f, f + 1.0, jnp.asarray(0), jnp.asarray(False), jnp.asarray(1),
        reg_lambda=d["lam"], max_iter=300, epsilon=eps,
    )
    return np.asarray(new_f), int(i), bool(done)


@pytest.mark.parametrize("eps", [1e-5, 10.0])
@pytest.mark.parametrize("lam", [1.0, 0.0])
def test_jacobi_step_matches_jax_step(eps, lam):
    d = _step_inputs(3, lam=lam)
    want, i, done = _jax_step(d, eps)
    got, state = _port_step(d, eps)
    assert i == 1 and int(state[spmv.ITERS]) == 1
    assert bool(state[spmv.DONE]) == done == (eps == 10.0)
    np.testing.assert_allclose(got, want, **TOL)
    labeled = d["is_labeled"]
    np.testing.assert_array_equal(got[labeled], d["labels"][labeled])


def test_jacobi_step_nan_delta_is_not_done():
    """A NaN square leaves `done` false, as jnp.max(...) < eps does."""
    d = _step_inputs(4, nan_row=20)
    d["is_labeled"][20] = False
    want, _, done = _jax_step(d, 1e9)
    got, state = _port_step(d, 1e9)
    assert not done and not bool(state[spmv.DONE]) and int(state[spmv.ITERS]) == 1
    assert np.isnan(got[20]) and np.isnan(want[20])


def test_jacobi_step_after_done_is_a_no_op():
    d = _step_inputs(5)
    state = spmv.new_state("cpu")
    state[spmv.DONE] = 1
    state[spmv.ITERS] = 4
    got, state = _port_step(d, 1e-5, state=state)
    assert (got == 7.0).all()  # the output buffer is untouched
    assert state.tolist() == [0, 1, 4, 0]


def test_wrappers_reject_bad_inputs():
    d = _step_inputs(6)
    f, nbr, w = _t(d["f"]), _t(d["nbr"]), _t(d["w"])
    with pytest.raises(TypeError):
        spmv.knn_spmv(f, nbr.long(), w)
    with pytest.raises(ValueError):
        spmv.knn_spmv(f[:-1], nbr, w)
    with pytest.raises(ValueError):  # f_in and f_out must not alias
        spmv.jacobi_step(f, f, nbr, w, f, f, f, _t(d["is_labeled"]),
                         spmv.new_state("cpu"), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 6, 13, 32, 40])
def test_cuda_kernels_match_plain(K):
    """Both kernels against their plain versions on the card, at ragged
    degrees (sub-warps of 1..32 lanes, and more slots than lanes), with a
    hub, -1 padding and isolated rows; the Jacobi kernel in both modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    d = _step_inputs(7, n=3001, K=K)
    d["nbr"][:, 0] = 5
    g = {k: _t(v).to(dev) for k, v in d.items() if isinstance(v, np.ndarray)}
    f = g["f"]
    got = spmv.knn_spmv(f, g["nbr"], g["w"])
    want = spmv.knn_spmv_plain(f, g["nbr"], g["w"])
    torch.testing.assert_close(got, want, **TOL)
    denom = torch.where(g["degree"] + 1.0 > 0, g["degree"] + 1.0, 1.0)
    args = (g["nbr"], g["w"], denom, g["prior"], g["labels"], g["is_labeled"])
    for done0 in (0, 1):
        outs, states = [], []
        for step in (spmv.jacobi_step, spmv.jacobi_step_plain):
            out, st = torch.full_like(f, 7.0), spmv.new_state(dev)
            st[spmv.DONE] = done0
            step(f, out, *args, st, 1e-5)
            outs.append(out)
            states.append(st)
        torch.cuda.synchronize()
        torch.testing.assert_close(outs[0], outs[1], **TOL)
        assert states[0].tolist() == states[1].tolist()
        if done0:
            assert (outs[0] == 7.0).all()


def _jax_segment(d, eps, f, f_prev, i0, stop_at):
    out = _propagate_segment(
        jnp.asarray(d["nbr"]), jnp.asarray(d["w"]), jnp.asarray(d["degree"]),
        jnp.asarray(d["prior"]), jnp.asarray(d["labels"]), jnp.asarray(d["is_labeled"]),
        jnp.asarray(f), jnp.asarray(f_prev), jnp.asarray(i0), jnp.asarray(False),
        jnp.asarray(stop_at), reg_lambda=d["lam"], max_iter=300, epsilon=eps,
    )
    f, f_prev, i, done, sel = out
    return np.asarray(f), np.asarray(f_prev), int(i), bool(done), np.asarray(sel)


@pytest.mark.parametrize("converges", ["inside", "outside"])
@pytest.mark.parametrize("steps", [1, 2, 3, 7])
def test_jacobi_segment_matches_jax_segment(steps, converges):
    """`jacobi_step_plain(steps=s)` against JAX's `_propagate_segment` with
    `stop_at` s steps on, from the same carried state (the iterate after 3
    steps): the iterate, the step count, done, the pre-step iterate and the
    buffer that holds the result. This is the contract the one-launch
    kernel keeps."""
    d = _step_inputs(8)
    i0 = 3
    f3, f2, _, _, _ = _jax_segment(d, 0.0, d["f"], d["f"] + 1.0, 0, i0)
    deltas, f = [], f3
    for k in range(steps):  # the segment's max squares, step by step
        f_next, *_ = _jax_segment(d, 0.0, f, f, 0, 1)
        deltas.append(float(((f_next - f) ** 2).max()))
        f = f_next
    if converges == "inside":  # done at the segment's 2nd step (1st when s = 1)
        c = min(2, steps)
        assert c == 1 or deltas[1] < deltas[0]
        eps = 2 * deltas[0] if c == 1 else (deltas[0] * deltas[1]) ** 0.5
    else:
        eps = 0.5 * min(deltas)
    want_f, want_prev, want_i, want_done, want_sel = _jax_segment(d, eps, f3, f2, i0, i0 + steps)
    assert want_done == (converges == "inside")

    denom = d["degree"] + np.float32(d["lam"])
    denom = np.where(denom > 0, denom, np.float32(1.0)).astype(np.float32)
    bufs = (_t(f3).clone(), torch.full((f3.shape[0],), 7.0))
    state = spmv.new_state("cpu")
    state[spmv.ITERS] = i0
    spmv.jacobi_step(bufs[0], bufs[1], _t(d["nbr"]), _t(d["w"]), _t(denom),
                     np.float32(d["lam"]) * _t(d["prior"]), _t(d["labels"]),
                     _t(d["is_labeled"]), state, eps, steps)
    i, done = int(state[spmv.ITERS]), bool(state[spmv.DONE])
    assert (i, done) == (want_i, want_done)
    ran = i - i0
    np.testing.assert_allclose(bufs[ran % 2].numpy(), want_f, **TOL)
    np.testing.assert_allclose(bufs[(ran + 1) % 2].numpy(), want_prev, **TOL)
    np.testing.assert_allclose(bufs[(ran + int(done)) % 2].numpy(), want_sel, **TOL)


# (N, Kp, graph, steps, eps, kind): kind "nan" puts a NaN in an unlabeled
# row's prior, "done" starts from a finished run
SEGMENT_CASES = [
    (3001, 6, "local", 1, 1e-5, "run"),
    (3001, 6, "local", 2, 1e-5, "run"),
    (3001, 6, "local", 3, 1e-5, "run"),
    (3001, 6, "local", 100, 1e-5, "run"),  # converges inside the segment
    (3001, 6, "local", 3, 0.0, "run"),  # never done: odd and even step counts
    (3001, 6, "local", 4, 0.0, "run"),
    (3001, 6, "local", 5, 1e-5, "nan"),
    (3001, 6, "local", 3, 1e-5, "done"),
    (3001, 1, "local", 5, 1e-5, "run"),
    (3001, 13, "local", 5, 1e-5, "run"),
    (3001, 32, "local", 5, 1e-5, "run"),
    (3001, 40, "local", 5, 1e-5, "run"),
    (3001, 200, "local", 5, 1e-5, "run"),  # too wide for a stage: read directly
    (12, 6, "local", 100, 1e-5, "run"),  # below one tile
    (3001, 6, "uniform", 100, 1e-5, "run"),
    (3001, 32, "uniform", 100, 1e-5, "run"),
    (200_003, 32, "local", 100, 1e-5, "run"),  # many tiles a block, a ragged last
    (200_003, 32, "uniform", 3, 0.0, "run"),
]


def _segment_inputs(n, K, graph, kind, seed=9):
    rng = np.random.default_rng(seed)
    if graph == "uniform":
        nbr, w = _graph(n, K, seed, local_frac=0.0)
    else:  # the main path's window-local graph: 97% within +-400 rows
        nbr, w = _graph(n, K, seed, local_frac=0.97, spread=400)
    degree = w.sum(axis=1).astype(np.float32)
    prior = rng.uniform(0.05, 0.95, n).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    is_labeled = rng.random(n) < 0.05
    if kind == "nan":
        prior[5] = np.nan
        is_labeled[5] = False
    f = np.where(is_labeled, labels, rng.uniform(0, 1, n)).astype(np.float32)
    denom = degree + np.float32(1.0)
    return f, (nbr, w, denom, prior, labels, is_labeled)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,graph,steps,eps,kind", SEGMENT_CASES)
def test_cuda_jacobi_segment_is_one_launch(n, K, graph, steps, eps, kind):
    """A segment of `steps` Jacobi steps on the card: one kernel launch per
    call, both buffers and (done, steps) equal to the plain version's, and
    the same bits when run again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    f, graph_args = _segment_inputs(n, K, graph, kind)
    args = [_t(a).to(dev) for a in graph_args]

    def run(step):
        bufs = (_t(f).to(dev), torch.full((n,), 7.0, device=dev))
        state = spmv.new_state(dev)
        if kind == "done":
            state[spmv.DONE], state[spmv.ITERS] = 1, 4
        before = spmv.jacobi_step.launches
        step(*bufs, *args, state, eps, steps)
        torch.cuda.synchronize()
        if step is spmv.jacobi_step:
            assert spmv.jacobi_step.launches == before + 1
        return bufs, state

    (a0, a1), sa = run(spmv.jacobi_step)
    (b0, b1), sb = run(spmv.jacobi_step)
    (p0, p1), sp = run(spmv.jacobi_step_plain)
    assert sa[[spmv.DONE, spmv.ITERS]].tolist() == sp[[spmv.DONE, spmv.ITERS]].tolist()
    for got, again, want in ((a0, b0, p0), (a1, b1, p1)):
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)
    if kind == "done":
        assert sa.tolist() == sp.tolist() and (a1 == 7.0).all()
    if kind == "nan":
        assert not bool(sa[spmv.DONE]) and int(sa[spmv.ITERS]) == steps
    if eps == 0.0:
        assert int(sa[spmv.ITERS]) == steps
