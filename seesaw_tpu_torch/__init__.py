"""seesaw_tpu_torch: the seesaw-tpu serving path in PyTorch, for NVIDIA Hopper.

A port of `seesaw_tpu` (JAX) beside it. Module paths and names mirror the
JAX package so that each module's counterpart is easy to find. The port
imports `torch` and nothing of `seesaw_tpu`, not even its framework-free
modules: it keeps its own copies of those (`basic_types`, `labeldb`,
`query_interface`, `calibration`, `box_utils`, `dataset`,
`indices.interface`, `indices.meta`, `runtime`, `loops.loop_base`,
`utils.transactional`, `models.embeddings`, `models.tokenizer`). The types a caller of the port
needs are exported here, so a program that drives the port names only this
package.

Every function that holds tensors takes an explicit `device`; nothing picks
one for the caller. The hand-written kernels on the serving path (CUDA C++
for sm_90a in `csrc/`: the frame-max scan `ops.fused_scoring`, the kNN
SpMV / Jacobi step `ops.spmv` and the CLIP towers' attention
`ops.attention`) are built with `nvcc` at first use; on CPU tensors their
plain PyTorch versions run.
"""

__version__ = "0.1.0"

# name -> module it lives in; imported on first access so a bare import stays
# light
_EXPORTS = {
    "make_session": "seesaw_tpu_torch.session",
    "Session": "seesaw_tpu_torch.session",
    "load_index": "seesaw_tpu_torch.indices.loader",
    "Box": "seesaw_tpu_torch.basic_types",
    "IndexSpec": "seesaw_tpu_torch.basic_types",
    "SessionParams": "seesaw_tpu_torch.basic_types",
    "GlobalDataManager": "seesaw_tpu_torch.dataset",
    "HashEmbedding": "seesaw_tpu_torch.models.embeddings",
    "VectorMeta": "seesaw_tpu_torch.indices.meta",
    "BitMap": "seesaw_tpu_torch.runtime.bitmap",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(module), name)
