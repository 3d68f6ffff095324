"""Differentiable rasterization API (port of
`taichi_gaussian_rasterizer_tpu.ops.raster.function`).

One `torch.autograd.Function` carries the blend on both devices, so the
CPU tests run the glue the card runs:

* forward: the forward kernel (`forward.py`) on CUDA tensors, its plain
  version on CPU tensors;
* backward: per-slot gradient rows from the backward kernel
  (`backward.py`) or its plain version, summed per point by
  `reduce_slots_by_point` (a stable sort and gather in plain torch, then
  the segment-sum kernel of `reduce.py` or its plain version), then the
  per-point chain from the conic transport rows to the packed (mean,
  axis, sigma, alpha) form.

The weight image is differentiable as well (an extension over the Taichi
reference, as in the JAX package). Training mode's heuristics (prune
cost, split score) and per-point visibility arrive as the gradients of a
zero `heuristic_sink` (N, 2) and `visibility_sink` (N,) passed in, the
JAX package's functional design; the backward computes them as extra
slot rows. Without a visibility sink, `compute_visibility` (or
`compute_point_heuristic`) takes the visibility from the forward instead:
the forward kernel's per-slot output, summed per point by
`reduce_slots_by_point` (kernel 3 on the card) and detached, in
`RasterOut.visibility`. Non-blending (quantile) outputs are detached.

Not ported yet, and raising `NotImplementedError` instead of doing
nothing: saturation-front truncation (`truncate_mapping`,
`probe_visit_chunks`; ROADMAP queue 1 item 11). Left out because they
exist only for XLA's static shapes: `capacity`, `reduce_capacity`,
`visit_capacity` and the `impl`/`max_points_per_tile` switch, so
`RasterOut.bin_overflow` is always None.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ...config import RasterConfig
from ..mapper import TileMapping, map_to_tiles
from .backward import rasterize_backward
from .forward import rasterize_forward
from .reduce import segment_sums_by_sorted_key


class RasterOut(NamedTuple):
  image: torch.Tensor                        # (H, W, F)
  image_weight: torch.Tensor                 # (H, W) accumulated alpha
  point_heuristic: Optional[torch.Tensor]    # via heuristic-sink gradients
  visibility: Optional[torch.Tensor]         # (N,) total blend weight
  bin_overflow: Optional[torch.Tensor] = None  # truncation only (not ported)


_TRUNCATION = ("saturation-front truncation is not ported yet: "
               "ROADMAP queue 1 item 11")


def reduce_slots_by_point(slots: torch.Tensor,
                          mapping: TileMapping) -> torch.Tensor:
  """(R, K) per-overlap-slot rows -> (N, R) per-point sums.

  A stable sort of overlap_to_point groups each point's slots in slot
  order, with the sentinel slots last; the rows are gathered into that
  order and summed per point over the mapper's point_offsets segments."""
  keys, order = torch.sort(mapping.overlap_to_point, stable=True)
  grouped = slots.index_select(1, order)
  return segment_sums_by_sorted_key(keys, grouped, mapping.point_offsets,
                                    mapping.point_sentinel).T


def _chain_to_packed(points: torch.Tensor, per_point: torch.Tensor,
                     antialias: bool):
  """Per-point (N, R) sums -> (grad_points (N, 7), prune-cost scale, first
  row after the point rows). Conic rows are gradients wrt (mean, qa, qb,
  qc, log_pa) and are chained here to (mean, axis, sigma, alpha)."""
  if antialias:
    return per_point[:, :7], 1.0, 7
  ax, ay = points[:, 2], points[:, 3]
  pa = points[:, 6]
  # a culled point's packed row is all zeros and it has no slots: give it
  # unit sigmas so that its zero sums chain to zero, not to 0 * inf = NaN
  # (the JAX package's chain returns NaN there)
  live = (points[:, 4] > 0) & (points[:, 5] > 0)
  sx = torch.where(live, points[:, 4], torch.ones_like(pa))
  sy = torch.where(live, points[:, 5], torch.ones_like(pa))
  gmx, gmy = per_point[:, 0], per_point[:, 1]
  gqa, gqb, gqc = per_point[:, 2], per_point[:, 3], per_point[:, 4]
  glogpa = per_point[:, 5]
  isx2 = 1.0 / (sx * sx)
  isy2 = 1.0 / (sy * sy)
  d_ax = 2 * ax * isx2 * gqa + ay * (isx2 - isy2) * gqb + 2 * ax * isy2 * gqc
  d_ay = 2 * ay * isy2 * gqa + ax * (isx2 - isy2) * gqb + 2 * ay * isx2 * gqc
  d_sx = (-2.0 * isx2 / sx) * (gqa * ax * ax + gqb * ax * ay + gqc * ay * ay)
  d_sy = (-2.0 * isy2 / sy) * (gqa * ay * ay - gqb * ax * ay + gqc * ax * ax)
  positive = pa > 0
  d_alpha = torch.where(positive,
                        glogpa / torch.where(positive, pa, torch.ones_like(pa)),
                        torch.zeros_like(pa))
  grad_points = torch.stack([gmx, gmy, d_ax, d_ay, d_sx, d_sy, d_alpha], dim=1)
  # the conic rows transport the sum of (dL/da_raw)^2: the prune cost
  # takes the per-point pa^2 factor here
  return grad_points, pa * pa, 6


class _Rasterize(torch.autograd.Function):
  """The blend as an autograd node: forward kernel 1, backward kernels 2
  and 3 (or their plain versions on the CPU)."""

  @staticmethod
  def forward(ctx, points, features, heuristic_sink, visibility_sink,
              mapping, image_size, config, compute_visibility):
    image, weight, *slot_vis = rasterize_forward(
        points, features, mapping, image_size, config, compute_visibility)
    ctx.save_for_backward(points, features, image, weight)
    ctx.mapping, ctx.config = mapping, config
    ctx.heuristic = config.compute_point_heuristic and heuristic_sink is not None
    ctx.vis_row = visibility_sink is not None
    if not slot_vis:
      return image, weight
    ctx.mark_non_differentiable(slot_vis[0])
    return image, weight, slot_vis[0]

  @staticmethod
  def backward(ctx, grad_image, grad_weight, grad_slot_vis=None):
    points, features, image, weight = ctx.saved_tensors
    config, mapping = ctx.config, ctx.mapping
    f = features.shape[1]
    slots = rasterize_backward(
        points, features, mapping, config, image, weight,
        grad_image.contiguous(), grad_weight.contiguous(),
        compute_point_heuristic=ctx.heuristic, vis_row=ctx.vis_row)
    per_point = reduce_slots_by_point(slots, mapping)         # (N, R)
    grad_points, prune_scale, col = _chain_to_packed(points, per_point,
                                                     config.antialias)
    heuristic = vis = None
    if ctx.heuristic:
      heuristic = torch.stack(
          [per_point[:, col] * prune_scale, per_point[:, col + 1]], dim=1)
      col += 2
    if ctx.vis_row:
      vis = per_point[:, col]
      col += 1
    return (grad_points, per_point[:, col:col + f], heuristic, vis,
            None, None, None, None)


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
    config: RasterConfig; `compute_point_heuristic` computes the heuristic
      rows in the backward
    heuristic_sink: optional (N, 2) zeros that require grad; after
      backward its `.grad` is (prune_cost, split_score) when
      config.compute_point_heuristic is set (no gradient otherwise)
    visibility_sink: optional (N,) zeros that require grad; after
      backward its `.grad` is each point's visibility (the sum of its
      blend weights over the image's pixels)

  Returns RasterOut with image (H, W, F) and image_weight (H, W), both
  differentiable wrt gaussians2d and features in blending mode.
  Non-blending (quantile) outputs are detached, as in the JAX package.
  With config.compute_visibility or config.compute_point_heuristic and no
  visibility_sink, RasterOut.visibility is each point's visibility from
  the forward (detached; in quantile mode the number of pixels that
  selected the point).
  """
  compute_visibility = ((config.compute_visibility
                         or config.compute_point_heuristic)
                        and visibility_sink is None)
  if not config.use_alpha_blending:
    with torch.no_grad():
      image, weight, *slot_vis = rasterize_forward(
          gaussians2d, features, mapping, image_size, config,
          compute_visibility)
  else:
    image, weight, *slot_vis = _Rasterize.apply(
        gaussians2d, features, heuristic_sink, visibility_sink, mapping,
        tuple(image_size), config, compute_visibility)
  visibility = None
  if compute_visibility:
    visibility = reduce_slots_by_point(slot_vis[0].detach()[None], mapping)[:, 0]
  return RasterOut(image, weight, None, visibility)


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
