"""The port's loop registry holds the JAX package's methods. The port's model
registry (`seesaw_tpu_torch.models.registry`): one cached
embedding per (name, device), a `clip-*` model on the device it was asked
for, and "cuda" and "cuda:<current>" as one card (`cuda`-marked, skipped
without a GPU)."""
import pytest
import torch

from seesaw_tpu_torch.models.clip import ClipEmbedding
from seesaw_tpu_torch.models.embeddings import HashEmbedding
from seesaw_tpu_torch.models.registry import load_embedding


def test_cache_is_keyed_by_name_and_device():
    a = load_embedding("hash-8", "cpu")
    assert isinstance(a, HashEmbedding) and a.dim == 8
    assert load_embedding("hash-8", torch.device("cpu")) is a
    assert load_embedding("hash-16", "cpu") is not a


def test_clip_variant_loads_on_the_device_asked_for():
    emb = load_embedding("clip-test", "cpu")
    assert isinstance(emb, ClipEmbedding) and emb.dim == 16
    assert {p.device.type for p in emb.model.parameters()} == {"cpu"}
    assert load_embedding("clip-test", "cpu") is emb


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown model"):
        load_embedding("resnet-50", "cpu")


@pytest.mark.cuda
def test_cuda_and_indexed_cuda_share_one_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    current = f"cuda:{torch.cuda.current_device()}"
    emb = load_embedding("clip-test", "cuda")
    assert load_embedding("clip-test", current) is emb
    assert load_embedding("clip-test", torch.device(current)) is emb
    assert {str(p.device) for p in emb.model.parameters()} == {current}
    assert load_embedding("clip-test", "cpu") is not emb


def test_loop_registry_holds_every_jax_method():
    """The port's loop registry names the JAX package's eleven methods."""
    from seesaw_tpu.loops.registry import available_methods as jax_methods
    from seesaw_tpu_torch.loops.registry import available_methods

    assert available_methods() == jax_methods()
    assert len(available_methods()) == 11
