from .function import (RasterOut, probe_visit_chunks, rasterize,
                       rasterize_with_tiles, truncate_mapping)
from .forward import rasterize_forward, rasterize_tiles_plain
from . import tiles

__all__ = [
    "RasterOut",
    "probe_visit_chunks",
    "rasterize",
    "rasterize_with_tiles",
    "truncate_mapping",
    "rasterize_forward",
    "rasterize_tiles_plain",
    "tiles",
]
