"""The port's embedding explorer (`seesaw_tpu_torch.embedding_plot`)
against `seesaw_tpu.embedding_plot` on the same vectors, on the CPU.

Coordinates and `project()` within 1e-4 up to a per-axis sign (neither
package fixes the sign of an eigenvector), cluster ids equal, and the same
HTML data keys and query overlay."""
import json

import numpy as np
import pytest

from seesaw_tpu.embedding_plot import Visualizer as JaxVisualizer
from seesaw_tpu_torch.embedding_plot import Visualizer


def _clustered(rng, n, d, k):
    centers = rng.normal(size=(k, d)) * 4
    which = rng.integers(0, k, size=n)
    return (centers[which] + rng.normal(size=(n, d))).astype(np.float32), which


def _data(html):
    return json.loads(html.split("const D = ")[1].split(";\n")[0])


def _signs(got, want):
    """Per-axis signs that map `got` onto `want`."""
    return np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)


@pytest.mark.parametrize("n,d,k,iters", [(600, 16, 4, 30), (300, 32, 6, 25)])
def test_visualizer_matches_jax(tmp_path, n, d, k, iters):
    rng = np.random.default_rng(n + d)
    X, true_c = _clustered(rng, n, d, k)
    dbidx = np.arange(n) * 3 + 1
    jv, tv = JaxVisualizer(X, dbidx=dbidx), Visualizer(X, dbidx=dbidx, device="cpu")
    want, got = jv.fit_projection(), tv.fit_projection()
    assert got.shape == (n, 2)
    sign = _signs(got, want)
    np.testing.assert_allclose(got * sign, want, atol=1e-4)
    np.testing.assert_allclose(tv.project(X[:7]) * sign, jv.project(X[:7]), atol=1e-4)
    np.testing.assert_allclose(tv.project(X[:5]), got[:5], atol=1e-4)
    np.testing.assert_array_equal(tv.assign_clusters(k=k, iters=iters, seed=1),
                                  jv.assign_clusters(k=k, iters=iters, seed=1))
    agree = sum(np.unique(tv.cluster_id[true_c == c], return_counts=True)[1].max()
                for c in range(k))
    assert agree / n > 0.9
    q = X[true_c == 0].mean(axis=0)
    tv.add_query("target", q, topk=20)
    jv.add_query("target", q, topk=20)
    urls = [f"u{i}" for i in range(n)]
    t_data = _data(open(tv.write_html(str(tmp_path / "t.html"), urls=urls)).read())
    j_data = _data(open(jv.write_html(str(tmp_path / "j.html"), urls=urls)).read())
    assert t_data.keys() == j_data.keys()
    for key in ("c", "dbidx", "urls"):
        assert t_data[key] == j_data[key]
    for axis, s in zip("xy", sign):
        np.testing.assert_allclose(np.array(t_data[axis]) * s, j_data[axis], atol=2e-4)
    (tq,), (jq,) = t_data["queries"], j_data["queries"]
    assert tq["name"] == jq["name"] == "target" and tq["top"] == jq["top"]
    np.testing.assert_allclose(np.array(tq["xy"]) * sign, jq["xy"], atol=1e-4)
