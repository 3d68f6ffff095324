"""Rasterization API, forward only (port of
`taichi_gaussian_rasterizer_tpu.ops.raster.function`).

On CUDA tensors the forward runs through a `torch.autograd.Function` whose
`forward` launches the CUDA kernel; its `backward` raises until the
backward kernel is ported (ROADMAP queue 2 item 2). On CPU tensors the
plain version runs and autograd differentiates it as it is.

Not ported yet, and raising `NotImplementedError` instead of doing
nothing: `compute_visibility` and `compute_point_heuristic` and the
heuristic/visibility sinks (training mode, ROADMAP queue 1 item 9),
`use_depth16` (queue 1 item 10) and saturation-front truncation
(`truncate_mapping`, `probe_visit_chunks`; queue 1 item 11). Left out
because they exist only for XLA's static shapes: `capacity`,
`reduce_capacity`, `visit_capacity` and the `impl`/`max_points_per_tile`
switch (the plain version is what runs on the CPU).
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ...config import RasterConfig
from ..mapper import TileMapping, map_to_tiles
from .forward import rasterize_forward


class RasterOut(NamedTuple):
  image: torch.Tensor                        # (H, W, F)
  image_weight: torch.Tensor                 # (H, W) accumulated alpha
  point_heuristic: Optional[torch.Tensor]    # training mode (not ported)
  visibility: Optional[torch.Tensor]         # training mode (not ported)


_TRAINING_MODE = "training mode is not ported yet: ROADMAP queue 1 item 9"
_TRUNCATION = ("saturation-front truncation is not ported yet: "
               "ROADMAP queue 1 item 11")


class _RasterForward(torch.autograd.Function):
  """The CUDA forward kernel as an autograd node."""

  @staticmethod
  def forward(ctx, points, features, mapping, image_size, config):
    return rasterize_forward(points, features, mapping, image_size, config)

  @staticmethod
  def backward(ctx, grad_image, grad_weight):
    raise NotImplementedError(
        "backward raster kernel: ROADMAP queue 2 item 2")


def rasterize_with_tiles(
    gaussians2d: torch.Tensor, features: torch.Tensor, mapping: TileMapping,
    image_size: Tuple[int, int], config: RasterConfig,
    heuristic_sink: Optional[torch.Tensor] = None,
    visibility_sink: Optional[torch.Tensor] = None) -> RasterOut:
  """Rasterize with a precomputed tile mapping.

  Args:
    gaussians2d: (N, 7) packed 2D gaussians
    features: (N, F) per-point features
    mapping: result of map_to_tiles
    image_size: (width, height)
    config: RasterConfig
    heuristic_sink, visibility_sink: training mode, not ported yet

  Returns RasterOut with image (H, W, F) and image_weight (H, W).
  Non-blending (quantile) outputs are detached, as in the JAX package.
  """
  if (config.compute_visibility or config.compute_point_heuristic
      or heuristic_sink is not None or visibility_sink is not None):
    raise NotImplementedError(_TRAINING_MODE)
  if gaussians2d.is_cuda:
    image, weight = _RasterForward.apply(gaussians2d, features, mapping,
                                         tuple(image_size), config)
  else:
    image, weight = rasterize_forward(gaussians2d, features, mapping,
                                      image_size, config)
  if not config.use_alpha_blending:
    image, weight = image.detach(), weight.detach()
  return RasterOut(image, weight, None, None)


def rasterize(gaussians2d: torch.Tensor, depth: torch.Tensor,
              features: torch.Tensor, image_size: Tuple[int, int],
              config: RasterConfig, use_depth16: bool = False,
              **kwargs) -> RasterOut:
  """map_to_tiles + rasterize_with_tiles."""
  if not gaussians2d.shape[0] == depth.shape[0] == features.shape[0]:
    raise ValueError(f"Size mismatch: {tuple(gaussians2d.shape)}, "
                     f"{tuple(depth.shape)}, {tuple(features.shape)}")
  mapping = map_to_tiles(gaussians2d, depth, image_size, config,
                         use_depth16=use_depth16)
  return rasterize_with_tiles(gaussians2d, features, mapping, image_size,
                              config, **kwargs)


def truncate_mapping(*args, **kwargs):
  raise NotImplementedError(_TRUNCATION)


def probe_visit_chunks(*args, **kwargs):
  raise NotImplementedError(_TRUNCATION)
