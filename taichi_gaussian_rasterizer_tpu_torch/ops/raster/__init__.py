from .function import (RasterOut, TruncationGuard, probe_visit_chunks,
                       rasterize, rasterize_with_tiles, reduce_slots_by_point,
                       truncate_mapping)
from .forward import rasterize_forward, rasterize_tiles_plain
from .backward import live_grad_rows, rasterize_backward, raster_backward_plain
from .reduce import segment_sums_by_sorted_key, segment_sums_plain
from . import tiles

__all__ = [
    "RasterOut",
    "probe_visit_chunks",
    "rasterize",
    "rasterize_with_tiles",
    "truncate_mapping",
    "TruncationGuard",
    "rasterize_forward",
    "rasterize_tiles_plain",
    "reduce_slots_by_point",
    "live_grad_rows",
    "rasterize_backward",
    "raster_backward_plain",
    "segment_sums_by_sorted_key",
    "segment_sums_plain",
    "tiles",
]
