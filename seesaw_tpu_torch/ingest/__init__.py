"""Offline ingestion: images -> multiscale tiles -> CLIP vectors -> index."""

from .tiling import generate_multiscale_tiling, pyramid_levels, strided_tiles  # noqa: F401
from .pipeline import create_multiscale_index, create_coarse_index  # noqa: F401
