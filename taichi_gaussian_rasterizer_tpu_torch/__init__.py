"""taichi_gaussian_rasterizer_tpu_torch -- PyTorch/CUDA port of
`taichi_gaussian_rasterizer_tpu`.

The module layout mirrors the JAX package's, so each module's counterpart
is found under the same name. The port covers the forward render path
(project -> SH shading -> tile map -> forward rasterize, with per-point
visibility and 16-bit depth keys as options), the training frame (the
backward raster pass, the per-point gradient reduction and training
mode's heuristic and visibility sinks), saturation-front truncation
for saturating (trained) scenes (`probe_visit_chunks`, `TruncationGuard`),
3DGS `.ply` checkpoints (`io`), the optimizers (`optim`), the 2D
image-fitting trainer (`models.renderer2d`,
`examples.fit_image_gaussians`), the utilities (`utils`) and multi-GPU
execution on `torch.distributed` (`parallel`). Each TPU kernel is a
hand-written CUDA kernel (`csrc/*.cu`, built with nvcc for Hopper at
first use) for CUDA tensors, with its plain PyTorch version for CPU
tensors. Imports torch, never jax.
"""

__version__ = "0.1.0"

from .config import RasterConfig
from .data_types import Gaussians2D, Gaussians3D, check_packed2d, check_packed3d
from .ops import CameraParams, evaluate_sh_at, project_points, project_to_image
from .ops.mapper import TileMapping, map_to_tiles, pad_to_tile
from .ops.raster import (RasterOut, TruncationGuard, probe_visit_chunks,
                         rasterize, rasterize_with_tiles, truncate_mapping)
from .models import (Rendering, render_gaussians, render_projected,
                     render_with_heuristics, viewspace_gradient)
from .utils import runtime

__all__ = [
    "RasterConfig",
    "Gaussians3D",
    "Gaussians2D",
    "check_packed3d",
    "check_packed2d",
    "CameraParams",
    "project_to_image",
    "project_points",
    "evaluate_sh_at",
    "TileMapping",
    "map_to_tiles",
    "pad_to_tile",
    "runtime",
    "RasterOut",
    "probe_visit_chunks",
    "truncate_mapping",
    "TruncationGuard",
    "rasterize",
    "rasterize_with_tiles",
    "Rendering",
    "render_gaussians",
    "render_projected",
    "render_with_heuristics",
    "viewspace_gradient",
]
