"""The port's copies of the JAX package's framework-free modules that no
path of the port called before, held against the originals on the same
inputs: `imgviz` (PIL drawing: pixel-equal images), `learners.vec_state`
(numpy: the inversion counts, the rank-loss gradient and the SGD state,
equal to the bit) and `models.bpe_train` (the BPE vocabulary build: equal
files, and the port's tokenizer over them encodes as the JAX package's).
With these the port has a counterpart for every module of `seesaw_tpu/`.
"""
import numpy as np
import PIL.Image
import pytest

import seesaw_tpu.basic_types as jbt
import seesaw_tpu.imgviz as jviz
import seesaw_tpu.learners.vec_state as jvs
import seesaw_tpu.models.bpe_train as jbpe
import seesaw_tpu_torch.basic_types as tbt
import seesaw_tpu_torch.imgviz as tviz
import seesaw_tpu_torch.learners.vec_state as tvs
import seesaw_tpu_torch.models.bpe_train as tbpe


def _img(seed, h=60, w=80):
    rng = np.random.default_rng(seed)
    return PIL.Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))


def _imdata(bt, accepted):
    return bt.Imdata(
        url="u", dbidx=3,
        boxes=[bt.Box(x1=2, y1=2, x2=20, y2=20, description="dog",
                      marked_accepted=accepted)],
        activations=[bt.ActivationData(box=bt.Box(x1=5, y1=5, x2=25, y2=25), score=0.5)],
    )


@pytest.mark.parametrize("accepted", [True, False])
def test_imgviz_matches_jax(accepted):
    boxes = np.array([[10, 10, 40, 30], [0, 5, 79, 59]])
    acts = [dict(x1=5, y1=5, x2=25, y2=25, score=0.73), dict(x1=30, y1=2, x2=70, y2=50,
                                                           score=-0.1)]
    pairs = [
        (jviz.draw_boxes(_img(0), boxes, labels=["dog", "cat"]),
         tviz.draw_boxes(_img(0), boxes, labels=["dog", "cat"])),
        (jviz.draw_activations(_img(1), acts), tviz.draw_activations(_img(1), acts)),
        (jviz.draw_imdata(_img(2), _imdata(jbt, accepted)),
         tviz.draw_imdata(_img(2), _imdata(tbt, accepted))),
        (jviz.montage([_img(i, 50, 50) for i in range(5)], cols=3, cell=50, pad=4),
         tviz.montage([_img(i, 50, 50) for i in range(5)], cols=3, cell=50, pad=4)),
    ]
    for want, got in pairs:
        assert got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_session_montage_matches_jax(tmp_path):
    paths = {}
    for d in (3, 4):
        paths[d] = tmp_path / f"{d}.png"
        _img(d).save(paths[d])

    def state(bt):
        return bt.SessionState(
            params=bt.SessionParams(index_spec=bt.IndexSpec(d_name="d", i_name="i"),
                                    interactive="plain", batch_size=1),
            gdata=[[_imdata(bt, True)], [bt.Imdata(url="u", dbidx=4, boxes=[],
                                                   activations=None)]],
            timing=[], reference_categories=[], query_string="q")

    got = tviz.session_montage(state(tbt), lambda d: paths[d], cols=2)
    want = jviz.session_montage(state(jbt), lambda d: paths[d], cols=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_vec_state_matches_jax():
    rng = np.random.default_rng(0)
    labs = (rng.random(40) < 0.3).astype(np.float64)
    scores = rng.normal(size=40)
    np.testing.assert_array_equal(tvs.compute_inversions(labs, scores),
                                  jvs.compute_inversions(labs, scores))
    X = rng.normal(size=(40, 16)).astype(np.float32)
    w = rng.normal(size=16).astype(np.float32)
    for margin in (0.0, 0.1):
        for a, b in zip(tvs.rank_loss_gradient(w, X, labs.astype(np.float32), margin),
                        jvs.rank_loss_gradient(w, X, labs.astype(np.float32), margin)):
            np.testing.assert_array_equal(a, b)
    t, j = (m.VecState(w, margin=0.1, lr=0.05, renormalize=True) for m in (tvs, jvs))
    for _ in range(3):
        idx = rng.choice(40, size=12, replace=False)
        assert t.update(X[idx], labs[idx]) == j.update(X[idx], labs[idx])
        np.testing.assert_array_equal(t.get_vec(), j.get_vec())


CORPUS = ["a photo of a dog", "a photo of a cat", "the quick brown fox jumps",
          "over the lazy dog", "dogs and cats and foxes", "Punctuation, too! 123"]


def test_bpe_train_matches_jax(tmp_path):
    from seesaw_tpu_torch.models.tokenizer import BpeTokenizer

    assert tbpe.train_bpe(CORPUS, 60) == jbpe.train_bpe(CORPUS, 60)
    t_files = tbpe.write_artifacts(tmp_path / "t", CORPUS, n_merges=80)
    j_files = jbpe.write_artifacts(tmp_path / "j", CORPUS, n_merges=80)
    for a, b in zip(t_files, j_files):
        assert a.read_bytes() == b.read_bytes()
    from seesaw_tpu.models.tokenizer import BpeTokenizer as JaxBpe

    t, j = BpeTokenizer(*map(str, t_files)), JaxBpe(*map(str, j_files))
    for text in CORPUS + ["an unseen doggo"]:
        assert list(t.encode(text)) == list(j.encode(text))
