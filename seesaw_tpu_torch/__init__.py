"""seesaw_tpu_torch: the seesaw-tpu serving path in PyTorch, for NVIDIA Hopper.

A port of `seesaw_tpu` (JAX) beside it. Module paths and names mirror the
JAX package so that each module's counterpart is easy to find; modules that
import no framework (`basic_types`, `labeldb`, `query_interface`,
`indices.meta`, `dataset`, `runtime`, `loops.loop_base`, `models.embeddings`)
are imported from `seesaw_tpu` and not copied. The types a caller of the
port needs from them are re-exported here, so a program that drives the port
names only this package. This package imports `torch` and never `jax`.

Every function that holds tensors takes an explicit `device`; nothing picks
one for the caller. The one hand-written kernel on the serving path
(`ops.fused_scoring.fused_frame_max`, CUDA C++ for sm_90a in `csrc/`) is
built with `nvcc` at first use; on CPU tensors its plain PyTorch version runs.
"""

__version__ = "0.1.0"

# name -> module it lives in; imported on first access so a bare import stays
# light, like seesaw_tpu
_EXPORTS = {
    "make_session": "seesaw_tpu_torch.session",
    "Session": "seesaw_tpu_torch.session",
    "load_index": "seesaw_tpu_torch.indices.loader",
    "Box": "seesaw_tpu.basic_types",
    "IndexSpec": "seesaw_tpu.basic_types",
    "SessionParams": "seesaw_tpu.basic_types",
    "GlobalDataManager": "seesaw_tpu.dataset",
    "HashEmbedding": "seesaw_tpu.models.embeddings",
    "VectorMeta": "seesaw_tpu.indices.meta",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(module), name)
