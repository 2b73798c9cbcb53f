"""Multi-device scaling: a mesh of devices in one process, the row-sharded
index, the sharded kNN build and propagation (counterpart of
`seesaw_tpu/parallel/`). `multihost` joins processes with
`torch.distributed`; `dryrun` drives every mesh path once."""

from .mesh import make_mesh  # noqa: F401
from .sharded_index import ShardedFrameIndex, sharded_query_topk  # noqa: F401
from .sharded_graph import sharded_exact_knn, sharded_propagate  # noqa: F401
