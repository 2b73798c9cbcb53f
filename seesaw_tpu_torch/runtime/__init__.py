"""Host-side runtime: bitmaps and share-once caching (the port's own copies
of the framework-free parts of `seesaw_tpu/runtime`)."""

from .bitmap import BitMap, FrozenBitMap  # noqa: F401
