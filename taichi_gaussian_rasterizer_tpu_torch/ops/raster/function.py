"""Differentiable rasterization API (port of
`taichi_gaussian_rasterizer_tpu.ops.raster.function`).

One `torch.autograd.Function` carries the blend on both devices, so the
CPU tests run the glue the card runs:

* forward: the forward kernel (`forward.py`) on CUDA tensors, its plain
  version on CPU tensors;
* backward: per-slot gradient rows from the backward kernel
  (`backward.py`) or its plain version, summed per point by
  `reduce_slots_by_point` (a stable sort of the slots by point in plain
  torch, then the kernel of `reduce.py` that gathers each point's slot
  rows through it and sums them, or its plain version), then the
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

Saturation-front truncation: on saturating scenes (trained, opaque
checkpoints) most of a tile's bin lies behind the point where all of its
pixels have saturated. `probe_visit_chunks` measures each tile's front
with one forward pass (kernel 1's per-tile `tile_front` output),
`truncate_mapping` keeps each tile's bin up to it, and
`rasterize_with_tiles(..., visit_chunks=...)` renders the kept prefixes:
the forward, the backward and the gradient reduction then run over the
kept slots only. It is exact while every truncated tile still saturates
within its kept prefix, which the forward's own front checks;
`RasterOut.bin_overflow` reports a crop, and `TruncationGuard` re-probes
and re-renders the frame before a training step can consume one.

Left out because they exist only for XLA's static shapes on the TPU:
`capacity`, `reduce_capacity` with `probe_reduce_capacity` and
`compact_visited_slots` (the static reduction budget that truncation
supersedes: the truncated mapping is already compact), and the
`impl`/`max_points_per_tile` switch. `visit_capacity` stays, optional: it
bounds the kept slots as in the JAX package.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ...config import RasterConfig
from ...utils import tracing
from ..mapper import TileMapping, cdiv, map_to_tiles, point_offsets
from .backward import rasterize_backward
from .forward import rasterize_forward
from .reduce import point_sums_by_order, slot_major


class RasterOut(NamedTuple):
  image: torch.Tensor                        # (H, W, F)
  image_weight: torch.Tensor                 # (H, W) accumulated alpha
  point_heuristic: Optional[torch.Tensor]    # via heuristic-sink gradients
  visibility: Optional[torch.Tensor]         # (N,) total blend weight
  bin_overflow: Optional[torch.Tensor] = None  # () bool with visit_chunks:
                                               # truncation cropped a tile


def reduce_slots_by_point(slots: torch.Tensor,
                          mapping: TileMapping) -> torch.Tensor:
  """(R, K) per-overlap-slot rows -> (N, R) per-point sums.

  A stable sort of overlap_to_point groups each point's slots in slot
  order, with the sentinel slots last; each point's slots are then
  gathered in that order and summed over the mapper's point_offsets
  segments (`point_sums_by_order`: on the card one kernel over the
  backward's slot-major rows). Spans `tgr.reduce.sort`: the sort, with
  counts `rows` (R), `chunks` (1: every row at once) and `kernel_rows`
  (the rows the kernel reduced from slot-major storage without a repack;
  0 on the plain CPU path), then one around the gather and the sums."""
  r, n = slots.shape[0], mapping.point_sentinel
  with tracing.span("reduce.sort") as s:
    s.count(rows=r, chunks=1,
            kernel_rows=r if slots.is_cuda and slot_major(slots) else 0)
    keys, order = torch.sort(mapping.overlap_to_point, stable=True)
  with tracing.span("reduce.sort"):
    return point_sums_by_order(keys, order, slots, mapping.point_offsets, n)


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
  and 3 (or their plain versions on the CPU). Outputs image, weight, then
  the forward's non-differentiable per-slot visibility and saturation
  front where asked for."""

  @staticmethod
  def forward(ctx, points, features, heuristic_sink, visibility_sink,
              mapping, image_size, config, compute_visibility, tile_front):
    ctx.trace_parent = tracing.current()
    with tracing.span("raster.fwd") as s:
      s.count(channels=features.shape[1])
      image, weight, *extra = rasterize_forward(
          points, features, mapping, image_size, config, compute_visibility,
          tile_front)
    ctx.save_for_backward(points, features, image, weight)
    ctx.mapping, ctx.config = mapping, config
    ctx.heuristic = config.compute_point_heuristic and heuristic_sink is not None
    ctx.vis_row = visibility_sink is not None
    if extra:
      ctx.mark_non_differentiable(*extra)
    return (image, weight, *extra)

  @staticmethod
  def backward(ctx, grad_image, grad_weight, *unused):
    with tracing.span("raster.bwd", parent=ctx.trace_parent):
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
    # the frame's projection and SH backward follow, up to the gradients of
    # its Gaussians3D tensors
    tracing.tail("project.bwd", ctx.trace_parent)
    return (grad_points, per_point[:, col:col + f], heuristic, vis,
            None, None, None, None, None)


def _check_truncation(config: RasterConfig, what: str):
  if not (config.saturation_early_exit and config.use_alpha_blending):
    raise ValueError(
        f"{what}: saturation-front truncation is exact only where the "
        "saturation early exit is; it needs saturation_early_exit and alpha "
        "blending")


def _tile_cover_chunks(mapping: TileMapping, g: int) -> torch.Tensor:
  """(T,) int64 chunks of g slots each tile's bin touches, counted from
  its start rounded down to a multiple of g: the unit of `visit_chunks`
  (the JAX package's iteration entries)."""
  starts = mapping.tile_ranges[:, 0].to(torch.int64)
  ends = mapping.tile_ranges[:, 1].to(torch.int64)
  return torch.where(ends > starts, cdiv(ends, g) - starts // g, 0)


def tile_front_chunks(tile_front: torch.Tensor, mapping: TileMapping,
                      g: int) -> torch.Tensor:
  """A saturation front in slots (`rasterize_forward(..., tile_front=
  True)`) in the JAX kernel's `satiters` unit: the signed count of g-slot
  chunks, from the tile's start rounded down to a multiple of g, up to and
  including the chunk of the front's last slot. (T,) int64."""
  starts = mapping.tile_ranges[:, 0].to(torch.int64)
  f = tile_front.to(torch.int64)
  chunks = cdiv(starts + f.abs(), g) - starts // g
  return torch.where(f != 0, torch.sign(f) * chunks, 0)


def probe_visit_chunks(gaussians2d: torch.Tensor, mapping: TileMapping,
                       config: RasterConfig, margin_chunks: int = 1
                       ) -> Tuple[torch.Tensor, int]:
  """Measure each tile's saturation front for `truncate_mapping`.

  One forward pass with a single zero feature channel (saturation depends
  on geometry and alpha only) returns kernel 1's per-tile front. Returns
  (visit_chunks (T,) int32 on the mapping's device, visit_capacity int):
  the chunks of `config.points_per_chunk` slots, counted from each bin's
  start rounded down to a multiple of it, that reach the front, plus
  `margin_chunks`, at most the bin; and their total in slots.

  Probe the frame that will be rendered (the same gaussians and mapping):
  a front measured on another frame can crop it, which the render then
  flags in `RasterOut.bin_overflow`. `margin_chunks` absorbs drift between
  the probed and the rendered frame; 0 is exact for a static scene.
  The probe counts every pixel of the tile grid, as the JAX kernel does,
  so its fronts equal the JAX package's; the render's own front counts
  the pixels inside its image, which can only stop sooner.
  """
  _check_truncation(config, "probe_visit_chunks")
  g = config.points_per_chunk
  th, tw = mapping.tile_shape
  image_size = (tw * config.tile_size, th * config.tile_size)
  with torch.no_grad():
    points = gaussians2d.detach()
    *_, front = rasterize_forward(points, points.new_zeros(points.shape[0], 1),
                                  mapping, image_size, config, tile_front=True)
  cover = _tile_cover_chunks(mapping, g)
  reach = tile_front_chunks(front, mapping, g).abs() + margin_chunks
  visit = torch.minimum(cover, reach).clamp(min=0)
  return visit.to(torch.int32), max(int(visit.sum()), 1) * g


def truncate_mapping(mapping: TileMapping, visit_chunks: torch.Tensor,
                     visit_capacity: Optional[int], g: int
                     ) -> Tuple[TileMapping, torch.Tensor, torch.Tensor]:
  """Keep each tile's first `visit_chunks[t]` chunks of g slots (its
  pre-saturation front).

  Tile t keeps the prefix [start, min(end, (start // g + keep) * g)) of its
  bin; the kept prefixes are compacted in tile order into a normal
  TileMapping with abutting bins, whose `point_offsets` are recomputed for
  the kept slots. Each point's kept slots keep their order, so the
  gradient reduction adds the same values in the same order as on the
  full mapping, less the dropped slots' zeros.

  visit_capacity (slots, a multiple of g) bounds the kept chunks, as in
  the JAX package: past it the runs are cropped in tile order and
  `drift_overflow` is set. None keeps every chunk asked for.

  Returns (the truncated mapping, truncated (T,) bool marking the tiles
  that lost slots, drift_overflow () bool). The result's `overflow` is
  mapping.overflow | drift_overflow.
  """
  starts = mapping.tile_ranges[:, 0].to(torch.int64)
  ends = mapping.tile_ranges[:, 1].to(torch.int64)
  device = starts.device
  cover = _tile_cover_chunks(mapping, g)
  keep = torch.minimum(cover, torch.as_tensor(visit_chunks, device=device)
                       .to(torch.int64)).clamp(min=0)
  drift_overflow = torch.zeros((), dtype=torch.bool, device=device)
  if visit_capacity is not None:
    if visit_capacity <= 0 or visit_capacity % g:
      raise ValueError(f"visit_capacity {visit_capacity} must be a positive "
                       f"multiple of points_per_chunk ({g})")
    cap = visit_capacity // g
    drift_overflow = keep.sum() > cap
    # crop the runs in tile order; they still abut
    run_start = (torch.cumsum(keep, 0) - keep).clamp(max=cap)
    keep = torch.minimum(keep, cap - run_start)

  kept = torch.where(keep > 0, torch.minimum(ends, (starts // g + keep) * g) - starts, 0)
  new_end = torch.cumsum(kept, 0)
  new_start = new_end - kept
  total = int(new_end[-1])                                  # the one host sync
  owner = torch.repeat_interleave(torch.arange(len(kept), device=device), kept,
                                  output_size=total)
  src = starts[owner] + torch.arange(total, device=device) - new_start[owner]
  overlap_to_point = mapping.overlap_to_point[src]
  n = mapping.point_sentinel
  truncated = TileMapping(
      overlap_to_point=overlap_to_point,
      overlap_to_tile=owner.to(torch.int32),
      tile_ranges=torch.stack([new_start, new_end], dim=1).to(torch.int32),
      tile_shape=mapping.tile_shape,
      total_overlaps=new_end[-1],
      overflow=mapping.overflow | drift_overflow,
      point_sentinel=n,
      point_offsets=point_offsets(overlap_to_point, n))
  return truncated, keep < cover, drift_overflow


class TruncationGuard:
  """Re-probe harness for saturation-front truncation in training loops.

  Truncation is exact only while every truncated tile still saturates
  within its kept prefix; a scene that drifts during training eventually
  breaks that, and the render flags `bin_overflow`. A loop that re-probes
  after the flag has already stepped on one cropped frame. The guard reads
  the flag before the caller steps, and re-probes and re-renders the same
  frame, so no step consumes a cropped render:

      guard = TruncationGuard(config)
      def frame(visit_chunks, visit_capacity):
          out = rasterize_with_tiles(points, features, mapping, size, config,
                                     visit_chunks=visit_chunks,
                                     visit_capacity=visit_capacity)
          return out, out.bin_overflow
      out = guard.render(points, mapping, frame)
      ... loss, backward and optimizer step on out ...

  Costs one scalar read of the flag per frame, plus a probe and a
  re-render per re-probe. The capacity grows monotonically in
  `capacity_headroom` steps, as in the JAX package.
  """

  def __init__(self, config: RasterConfig, margin_chunks: int = 1,
               capacity_headroom: float = 1.25):
    _check_truncation(config, "TruncationGuard")
    self.config = config
    self.margin_chunks = margin_chunks
    self.capacity_headroom = capacity_headroom
    self.visit_chunks: Optional[torch.Tensor] = None
    self.visit_capacity: int = 0
    self.reprobes: int = 0

  def probe(self, gaussians2d: torch.Tensor, mapping: TileMapping) -> None:
    """(Re)measure the saturation fronts on the current frame."""
    vc, cap = probe_visit_chunks(gaussians2d, mapping, self.config,
                                 self.margin_chunks)
    g = self.config.points_per_chunk
    # at most every chunk of every bin: no more can be kept. (The JAX
    # guard caps at its mapping's static capacity; the port's K is the
    # exact candidate count, and bins that share a chunk at their boundary
    # count it twice, so capping at K would crop a frame that keeps most
    # of its bins, and a fresh probe could never clear the flag.)
    every_chunk = int(_tile_cover_chunks(mapping, g).sum()) * g
    cap = min(cdiv(int(cap * self.capacity_headroom), g) * g, every_chunk)
    self.visit_chunks = vc
    # monotone: a shrinking scene keeps the larger capacity
    self.visit_capacity = max(cap, self.visit_capacity)

  def render(self, gaussians2d: torch.Tensor, mapping: TileMapping, render_fn):
    """Render one frame with truncation that is known not to crop.

    render_fn(visit_chunks, visit_capacity) returns (result, bin_overflow),
    the flag of the truncated render inside it. Returns the result of a
    render whose flag is clear; raises RuntimeError if a fresh probe of the
    same frame still crops, which means render_fn renders another frame
    than `gaussians2d` and `mapping`.
    """
    if self.visit_chunks is None:
      self.probe(gaussians2d, mapping)
    result, overflow = render_fn(self.visit_chunks, self.visit_capacity)
    if not bool(overflow):
      return result
    # the scene drifted past its probed fronts: re-probe, re-render
    self.reprobes += 1
    self.probe(gaussians2d, mapping)
    result, overflow = render_fn(self.visit_chunks, self.visit_capacity)
    if bool(overflow):
      raise RuntimeError(
          "TruncationGuard: the render is still cropped after a fresh probe; "
          "render_fn must render the frame passed to render (the same "
          "gaussians and mapping)")
    return result


def rasterize_with_tiles(
    gaussians2d: torch.Tensor, features: torch.Tensor, mapping: TileMapping,
    image_size: Tuple[int, int], config: RasterConfig,
    heuristic_sink: Optional[torch.Tensor] = None,
    visibility_sink: Optional[torch.Tensor] = None,
    visit_chunks: Optional[torch.Tensor] = None,
    visit_capacity: Optional[int] = None) -> RasterOut:
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
    visit_chunks / visit_capacity: saturation-front truncation
      (`probe_visit_chunks`, `truncate_mapping`): the forward, backward and
      reduction run over each tile's kept prefix only. Exact while every
      truncated tile saturates within it; otherwise RasterOut.bin_overflow
      is set (re-probe, or use TruncationGuard). Needs alpha blending and
      saturation_early_exit.

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
  truncated = None
  if visit_chunks is not None:
    _check_truncation(config, "visit_chunks")
    mapping, truncated, drift_overflow = truncate_mapping(
        mapping, visit_chunks, visit_capacity, config.points_per_chunk)
  if not config.use_alpha_blending:
    with torch.no_grad():
      image, weight, *extra = rasterize_forward(
          gaussians2d, features, mapping, image_size, config,
          compute_visibility)
  else:
    image, weight, *extra = _Rasterize.apply(
        gaussians2d, features, heuristic_sink, visibility_sink, mapping,
        tuple(image_size), config, compute_visibility, truncated is not None)
  visibility = None
  if compute_visibility:
    visibility = reduce_slots_by_point(extra[0].detach()[None], mapping)[:, 0]
  bin_overflow = None
  if truncated is not None:
    # a truncated tile is exact iff all its pixels stopped within the kept
    # prefix, by the kernel's own vote (front > 0); one whose kept prefix
    # is empty (front 0) is cropped as well. The input mapping's own
    # overflow is left out: it is the same with or without truncation.
    bin_overflow = drift_overflow | (truncated & (extra[-1] <= 0)).any()
  return RasterOut(image, weight, None, visibility, bin_overflow)


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
