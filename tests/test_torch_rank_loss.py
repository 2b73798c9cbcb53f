"""The port's rank losses (`seesaw_tpu_torch.ops.rank_loss`) against the JAX
package's (`seesaw_tpu.ops.rank_loss`) on the same seeded numpy inputs, with
ties planted in both sort keys: targets from a few levels, scores rounded to
one decimal so that many pairs tie, and pairs that tie in both.

Tolerance: rtol 1e-6 / atol 1e-6 for every value and gradient (f32 ops on
the same numbers; sums of up to n terms in another order). The sorted
gradient is an integer count and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seesaw_tpu.ops import rank_loss as J
from seesaw_tpu_torch.ops import rank_loss as T

TOL = dict(rtol=1e-6, atol=1e-6)


def _case(seed, n=37, levels=(0.0, 1.0)):
    rng = np.random.default_rng(seed)
    target = rng.choice(np.asarray(levels, np.float32), size=n).astype(np.float32)
    scores = np.round(rng.normal(size=n), 1).astype(np.float32)
    scores[3:7] = scores[2]  # a run of equal scores across targets
    target[10:13] = target[9]
    scores[10:13] = scores[9]  # ties in both keys
    valid = rng.random(n) < 0.85
    return target, scores, valid


CASES = [(0, (0.0, 1.0)), (1, (0.0, 1.0)), (2, (0.0, 0.5, 1.0)), (3, (0.0, 0.25, 0.5, 1.0))]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed,levels", CASES)
@pytest.mark.parametrize("margin", [0.0, 0.1])
def test_matrices_match_jax(seed, levels, margin):
    target, scores, _ = _case(seed, levels=levels)
    for jf, tf, kw in (
        (J.pairwise_rank_loss_matrix, T.pairwise_rank_loss_matrix, dict(margin=margin)),
        (J.pairwise_logistic_loss_matrix, T.pairwise_logistic_loss_matrix, {}),
        (J.signed_inversions_matrix, T.signed_inversions_matrix, dict(margin=margin)),
    ):
        want = np.asarray(jf(jnp.asarray(target), jnp.asarray(scores), **kw))
        got = tf(_t(target), _t(scores), **kw).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=jf.__name__)


@pytest.mark.parametrize("seed,levels", CASES)
@pytest.mark.parametrize("kind", ["rank", "logistic"])
@pytest.mark.parametrize("masked", [False, True])
def test_sums_and_gradients_match_jax(seed, levels, kind, masked):
    """Column sums, max-inversion counts, and the gradient of the summed
    loss with respect to the scores (the hinge's boundary pairs active)."""
    target, scores, valid = _case(seed, levels=levels)
    kw = dict(margin=0.0) if kind == "rank" else {}
    jf = J.pairwise_rank_loss_sum if kind == "rank" else J.pairwise_logistic_loss_sum
    tf = T.pairwise_rank_loss_sum if kind == "rank" else T.pairwise_logistic_loss_sum
    jv = jnp.asarray(valid) if masked else None
    tv = _t(valid) if masked else None

    want_l, want_c = jf(jnp.asarray(target), jnp.asarray(scores),
                        return_max_inversions=True, valid=jv, **kw)
    got_l, got_c = tf(_t(target), _t(scores), return_max_inversions=True, valid=tv, **kw)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))

    want_g = jax.grad(lambda s: jf(jnp.asarray(target), s, valid=jv, **kw).sum())(
        jnp.asarray(scores))
    s = _t(scores).clone().requires_grad_(True)
    tf(_t(target), s, valid=tv, **kw).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("seed,levels", CASES)
def test_quick_gradient_parts_match_jax(seed, levels):
    target, scores, _ = _case(seed, levels=levels)
    want = J.quick_pairwise_gradient_parts(jnp.asarray(target), jnp.asarray(scores))
    got = T.quick_pairwise_gradient_parts(_t(target), _t(scores))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.numpy()), np.asarray(w))


@pytest.mark.parametrize("seed,levels", CASES)
@pytest.mark.parametrize("normalized", [True, False])
def test_cheap_rank_loss_forward_and_backward_match_jax(seed, levels, normalized):
    """Forward |sorted gradient| x factor; the backward is the JAX custom
    VJP (the sorted gradient x factor x cotangent)."""
    target, scores, _ = _case(seed, levels=levels)
    cot = np.random.default_rng(seed + 100).normal(size=target.shape[0]).astype(np.float32)
    want, vjp = jax.vjp(lambda s: J.cheap_pairwise_rank_loss(jnp.asarray(target), s, normalized),
                        jnp.asarray(scores))
    (want_g,) = vjp(jnp.asarray(cot))
    s = _t(scores).clone().requires_grad_(True)
    got = T.cheap_pairwise_rank_loss(_t(target), s, normalized)
    got.backward(_t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), **TOL)


def test_lexsort2_is_two_stable_sorts():
    """Primary ascending, ties by secondary ascending, then by position."""
    p = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0, 0.0])
    s = torch.tensor([2.0, 2.0, 1.0, 2.0, 1.0, 0.0])
    assert T._lexsort2(p, s).tolist() == np.lexsort((s.numpy(), p.numpy())).tolist()
    assert T._lexsort2(p, s).tolist() == [5, 1, 3, 2, 4, 0]
