"""The port's active-search stack against the JAX package's, on the CPU, on
the same seeded numpy inputs: `ops.ens.ens_expected_value` (planted ties in
the scores, seen rows at -inf, -1 padding and self edges in the graph,
blocks that do not divide N), the `loops.lknn_model` copy, and the index
that `efficient_nonmyopic_search` picks (vectorized and loop planners,
lookahead 1 and 2), plus the CEAS helpers.

Tolerance: ENS values bit for bit (the port rounds as XLA does: left-to-right
top-K sums and one fused multiply-add; near-tied candidates are common, so
the planner's first-maximum pick depends on it); planner values rtol 1e-6 /
atol 1e-6; picked indices and model arrays equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seesaw_tpu.loops import ens_search as JS
from seesaw_tpu.loops import lknn_model as JM
from seesaw_tpu.ops.ens import ens_expected_value as jax_ens
from seesaw_tpu_torch.loops import ens_search as TS
from seesaw_tpu_torch.loops import lknn_model as TM
from seesaw_tpu_torch.ops.ens import ens_expected_value as torch_ens

TOL = dict(rtol=1e-6, atol=1e-6)


def _ens_inputs(seed, n=301, D=6):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, size=(n, D)).astype(np.int32)
    nbr[::7, -2:] = -1  # padding
    nbr[5, 0] = 5  # a self edge
    num = rng.uniform(0.05, 0.95, size=n).astype(np.float32)
    den1 = (1.0 + rng.integers(0, 4, size=n)).astype(np.float32)
    # planted ties: scores from few levels, so the global top list ties
    scores = rng.choice(np.array([0.1, 0.25, 0.5, 0.75], np.float32), size=n)
    seen = rng.choice(n, size=n // 10, replace=False)
    num[seen] = -np.inf
    scores[seen] = -np.inf
    return scores, num, den1, nbr


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K,block", [(1, 64), (4, 100), (9, 1024)])
def test_ens_expected_value_matches_jax(seed, K, block):
    scores, num, den1, nbr = _ens_inputs(seed)
    want = np.asarray(jax_ens(jnp.asarray(scores), jnp.asarray(num), jnp.asarray(den1),
                              jnp.asarray(nbr), K=K, block_size=block))
    got = torch_ens(torch.from_numpy(scores), torch.from_numpy(num),
                    torch.from_numpy(den1), torch.from_numpy(nbr), K=K,
                    block_size=block).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got, want)  # bit for bit
    assert int(np.nanargmax(got)) == int(np.nanargmax(want))


def test_ens_tie_order_masks_the_lower_index():
    """All scores equal: the global top list holds the lowest ids (as
    lax.top_k's), so only those rows see themselves masked in it."""
    n, D, K = 40, 2, 3
    scores = np.full(n, 0.5, np.float32)
    num = np.full(n, 0.4, np.float32)
    den1 = np.ones(n, np.float32)
    nbr = np.stack([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n], 1).astype(np.int32)
    want = np.asarray(jax_ens(jnp.asarray(scores), jnp.asarray(num), jnp.asarray(den1),
                              jnp.asarray(nbr), K=K, block_size=16))
    got = torch_ens(torch.from_numpy(scores), torch.from_numpy(num), torch.from_numpy(den1),
                    torch.from_numpy(nbr), K=K, block_size=16).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(np.round(want, 6))) > 1  # the masks made rows differ


def _models(seed, n=60, k=4, labels=8):
    rng = np.random.default_rng(seed)
    nbr = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    nbr[::9, -1] = -1
    vecs = np.zeros((n, 3), np.float32)
    gamma = JM.initial_gamma_array(0.2, n)
    np.testing.assert_array_equal(TM.initial_gamma_array(0.2, n), gamma)
    jm = JM.LKNNModel.from_dataset(JM.Dataset.from_vectors(vecs), nbr=nbr, gamma=gamma)
    tm = TM.LKNNModel.from_dataset(TM.Dataset.from_vectors(vecs), nbr=nbr, gamma=gamma)
    for i, y in zip(rng.choice(n, size=labels, replace=False), rng.integers(0, 2, size=labels)):
        jm.condition_(int(i), int(y))
        tm.condition_(int(i), int(y))
    jm.condition_(int(nbr[0, 0]), 1)  # relabel a vertex
    tm.condition_(int(nbr[0, 0]), 1)
    return jm, tm


@pytest.mark.parametrize("seed", [3, 4])
def test_lknn_model_copy_matches_jax(seed):
    jm, tm = _models(seed)
    np.testing.assert_array_equal(tm.scores(), jm.scores())
    for k in (1, 5, 60):
        for a, b in zip(tm.top_k_remaining(k), jm.top_k_remaining(k)):
            np.testing.assert_array_equal(a, b)
    assert tm.probability_bound(2) == jm.probability_bound(2)
    c_t, c_j = tm.condition(7, 0), jm.condition(7, 0)
    np.testing.assert_array_equal(c_t.scores(), c_j.scores())
    np.testing.assert_array_equal(tm.dataset.get_labels()[0], jm.dataset.get_labels()[0])
    np.testing.assert_array_equal(tm.dataset.get_labels()[1], jm.dataset.get_labels()[1])


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("horizon,lookahead", [(1, 1), (3, 1), (2, 2), (5, 2)])
def test_nonmyopic_search_picks_the_jax_index(seed, horizon, lookahead):
    jm, tm = _models(seed)
    want = JS.efficient_nonmyopic_search(jm, reward_horizon=horizon, lookahead_limit=lookahead,
                                         pruning_on=False, implementation="vectorized")
    got = TS.efficient_nonmyopic_search(tm, reward_horizon=horizon, lookahead_limit=lookahead,
                                        pruning_on=False, implementation="vectorized",
                                        device="cpu")
    assert got.index == want.index
    np.testing.assert_allclose(got.value, want.value, **TOL)


@pytest.mark.parametrize("pruning", [False, True])
def test_loop_oracle_matches_jax(pruning):
    jm, tm = _models(6, n=14, k=3, labels=3)
    want = JS.efficient_nonmyopic_search(jm, reward_horizon=3, lookahead_limit=2,
                                         pruning_on=pruning, implementation="loop")
    got = TS.efficient_nonmyopic_search(tm, reward_horizon=3, lookahead_limit=2,
                                        pruning_on=pruning, implementation="loop")
    assert (got.index, got.value, got.pruned_fraction) == (want.index, want.value,
                                                           want.pruned_fraction)
    vec = TS.efficient_nonmyopic_search(tm, reward_horizon=3, lookahead_limit=2,
                                        pruning_on=False, device="cpu")
    assert vec.index == got.index


def test_vectorized_planner_needs_a_device():
    _, tm = _models(3)
    with pytest.raises(ValueError, match="device"):
        TS.efficient_nonmyopic_search(tm, reward_horizon=3, lookahead_limit=2, pruning_on=False)


def test_ceas_helpers_match_jax():
    jm, tm = _models(7, n=20, k=3, labels=4)
    probs = np.sort(np.random.default_rng(0).uniform(0, 1, 20))[::-1]
    for r in (1, 2, 5):
        assert TS.npb_expectation(r, probs) == JS.npb_expectation(r, probs)
    for t in (1, 2):
        got = TS.min_expected_cost_approx(2, t=t, model=tm, top_k=4)
        want = JS.min_expected_cost_approx(2, t=t, model=jm, top_k=4)
        assert (got.index, got.value) == (want.index, want.value)
