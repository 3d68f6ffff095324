"""Tile mapper: bin projected 2D gaussians into depth-sorted per-tile lists
(port of `taichi_gaussian_rasterizer_tpu.ops.mapper`).

Computes what the JAX mapper computes -- the same footprint with the
same `max_tile_span` clamp-and-flag, the same oriented-ellipse/tile
separating-axis test, the same per-tile front-to-back order -- in plain
torch with dynamic sizes:

  footprint -> candidate count per gaussian -> exclusive scan -> one
  host sync for the candidate total -> emit one (tile, depth) key per
  candidate, rejected candidates keyed past every tile -> one stable
  sort -> per-tile [start, end) ranges by searchsorted.

The key is the 64-bit `tile << 32 | depth_rank`, where depth_rank is the
gaussian's position in a stable depth sort: lexicographic (tile, depth)
order for any float dtype, ties broken by point index.

`use_depth16` sorts a 32-bit key instead, half the radix passes: the
depth clipped to [0, 1] and quantized to 16 bits (`trunc(d * 65535)`, as
the JAX mapper does) under the tile id, `tile << 16 | d16`, with the sign
bit flipped so that torch's signed int32 sort keeps the unsigned order.
The sort is stable, so quantized ties keep the emission order: point
index, or with `config.deterministic` the full depth (the candidates are
then emitted in depth order, as the JAX mapper's secondary full-depth
key orders them). Tile ids must stay under the 0xFFFF sentinel.

Left out, because they exist only for XLA's static shapes on the TPU:
`capacity` (buffers are sized from the synced total instead),
`emit_tails`/`probe_emit_tails` and the bucketed emission ladder, and the
two-level searchsorted.
"""

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ..config import RasterConfig
from ..utils import tracing
from . import lib


def cdiv(a: int, b: int) -> int:
  return -(-a // b)


def pad_to_tile(image_size: Tuple[int, int], tile_size: int) -> Tuple[int, int]:
  """Round an image size up to whole tiles."""
  return tuple(cdiv(int(x), tile_size) * tile_size for x in image_size)


def num_tiles(image_size: Tuple[int, int], tile_size: int) -> Tuple[int, int]:
  """(tiles across, tiles down)."""
  w, h = image_size
  return cdiv(int(w), tile_size), cdiv(int(h), tile_size)


@dataclass(frozen=True)
class TileMapping:
  """Result of map_to_tiles.

  Bins abut in one sorted overlap list: tile t's points, front to back,
  are overlap_to_point[tile_ranges[t, 0]:tile_ranges[t, 1]]. Real
  overlaps fill [0, total_overlaps); the candidates the separating-axis
  test rejected trail them with point `point_sentinel` (== N) and tile
  TH*TW, as in the JAX package's sentinel tail.

  point_offsets serves the gradient reduction
  (raster/function.py reduce_slots_by_point): sorting the slots by
  overlap_to_point groups them by point, with point i's real overlaps at
  [point_offsets[i], point_offsets[i+1]) and the sentinels after them.
  """
  overlap_to_point: torch.Tensor  # (K,) int32 point index, or N past the bins
  overlap_to_tile: torch.Tensor   # (K,) int32 tile index, or TH*TW past the bins
  tile_ranges: torch.Tensor       # (TH*TW, 2) int32 [start, end) per tile
  tile_shape: Tuple[int, int]     # (TH, TW)
  total_overlaps: torch.Tensor    # () int64 number of real (point, tile) pairs
  overflow: torch.Tensor          # () bool: a footprint exceeded max_tile_span
                                  # and was clamped
  point_sentinel: int             # == N
  point_offsets: torch.Tensor     # (N+1,) int32 segment starts in point-
                                  # sorted slot order

  @functools.cached_property
  def tile_order(self) -> torch.Tensor:
    """The CUDA raster kernels' tile queue order (`longest_first`),
    computed once per mapping and shared by its launches."""
    return longest_first(self.tile_ranges)


def point_offsets(overlap_to_point: torch.Tensor, n: int) -> torch.Tensor:
  """(N+1,) int32 starts of each point's segment in point-sorted slot
  order: the per-point count of real overlaps (the sentinel N dropped),
  exclusively scanned."""
  counts = torch.bincount(overlap_to_point.to(torch.int64), minlength=n + 1)[:n]
  return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)


def longest_first(tile_ranges: torch.Tensor) -> torch.Tensor:
  """(T,) int32 tile ids, longest bin first, ties in tile order: the
  order in which the CUDA raster kernels' persistent blocks take tiles, so
  that the longest bins start first and the short ones fill the tail. It
  decides no output value."""
  lengths = tile_ranges[:, 1] - tile_ranges[:, 0]
  return torch.argsort(lengths, descending=True, stable=True).to(torch.int32)


def _footprint(points: torch.Tensor, image_size, tile_size: int,
               alpha_threshold: float, max_span: int):
  """Per-gaussian tile footprint: first tile, clamped span and the inverse
  oriented-bounding-box basis. Gaussians at or below the alpha threshold
  get span 0."""
  mx, my = points[:, 0], points[:, 1]
  ax, ay = points[:, 2], points[:, 3]
  sx, sy = points[:, 4], points[:, 5]
  alpha = points[:, 6]

  valid = alpha > alpha_threshold
  gs = lib.gaussian_scale_factor(alpha, alpha_threshold)
  r0 = torch.clamp(sx * gs, min=1e-12)
  r1 = torch.clamp(sy * gs, min=1e-12)

  # ellipse AABB: axes u1 = axis * r0, u2 = perp(axis) * r1
  ext_x = torch.sqrt((ax * r0) ** 2 + (ay * r1) ** 2)
  ext_y = torch.sqrt((ay * r0) ** 2 + (ax * r1) ** 2)

  tw, th = num_tiles(image_size, tile_size)

  def axis_range(m, ext, nt):
    # clamp in float before the integer cast: far-off footprints must not
    # overflow int32 (the clamped results equal the JAX mapper's)
    lo = torch.clamp(torch.floor((m - ext) / tile_size), 0, nt - 1).to(torch.int32)
    hi = torch.clamp(torch.ceil((m + ext) / tile_size), 0, nt).to(torch.int32)
    hi = torch.clamp(torch.maximum(hi, lo + 1), max=nt)
    return lo, hi

  tx0, tx1 = axis_range(mx, ext_x, tw)
  ty0, ty1 = axis_range(my, ext_y, th)

  zero = torch.zeros_like(tx0)
  raw_x = torch.where(valid, tx1 - tx0, zero)
  raw_y = torch.where(valid, ty1 - ty0, zero)
  clipped = torch.any(raw_x > max_span) | torch.any(raw_y > max_span)

  return dict(
      mx=mx, my=my, tx0=tx0, ty0=ty0,
      span_x=torch.clamp(raw_x, 0, max_span),
      span_y=torch.clamp(raw_y, 0, max_span),
      ib=(ax / r0, ay / r0, -ay / r1, ax / r1),
      clipped=clipped)


def _sat_accept(lo_x, lo_y, ib, tile_size):
  """Oriented-ellipse vs tile separating-axis test; True = overlaps.
  lo_x/lo_y: tile lower corner relative to the mean; ib: the four
  inverse-basis entries (row-major). The extrema of a linear function
  over a box are sums of per-axis extrema, so no corners are enumerated."""
  hi_x = lo_x + tile_size
  hi_y = lo_y + tile_size
  ib00, ib01, ib10, ib11 = ib

  sep = None
  for bx, by in ((ib00, ib01), (ib10, ib11)):
    mn = (torch.minimum(bx * lo_x, bx * hi_x)
          + torch.minimum(by * lo_y, by * hi_y))
    mx = (torch.maximum(bx * lo_x, bx * hi_x)
          + torch.maximum(by * lo_y, by * hi_y))
    s = (mn > 1.0) | (mx < -1.0)
    sep = s if sep is None else (sep | s)
  return ~sep


def map_to_tiles(points: torch.Tensor, depth: torch.Tensor,
                 image_size: Tuple[int, int], config: RasterConfig,
                 use_depth16: bool = False) -> TileMapping:
  """Map gaussians to tiles, depth-sorted front to back within each tile.

  Args:
    points: (N, 7) packed 2D gaussians
    depth: (N,) or (N, 1) sort depths
    image_size: (width, height)
    config: RasterConfig (tile_size, alpha_threshold, max_tile_span,
      deterministic)
    use_depth16: sort on 16-bit quantized depths in [0, 1] (see the module
      docstring); raises ValueError when the tile grid reaches 0xFFFF tiles

  Under a torch.profiler profile the call is the span `tgr.map` of
  `utils.tracing`, counting the candidate keys it sorts (`candidates`)
  and the overlaps it keeps (`overlaps`), with its host sync `tgr.map.sync`.
  """
  with tracing.span("map") as sp:
    mapping = _map_to_tiles(points, depth, image_size, config, use_depth16)
    sp.count(candidates=mapping.overlap_to_point.shape[0],
             overlaps=mapping.total_overlaps)
    return mapping


def _map_to_tiles(points, depth, image_size, config, use_depth16):
  n = points.shape[0]
  if depth.ndim == 2:
    depth = depth[:, 0]
  device = points.device
  tile_size = config.tile_size
  tw, th = num_tiles(image_size, tile_size)
  n_tiles = tw * th
  if use_depth16 and n_tiles >= 0xFFFF:
    raise ValueError(
        f"tile grid {th}x{tw} aliases the depth16 sentinel tile id 0xFFFF; "
        "use use_depth16=False or a larger tile_size")

  fp = _footprint(points, image_size, tile_size, config.alpha_threshold,
                  config.max_tile_span)

  # candidates: every tile of each clamped footprint (row-major within
  # it), point by point; for deterministic depth16 keys the points are
  # taken in depth order, so that the stable sort breaks quantized ties
  # on the full depth
  counts = (fp["span_x"] * fp["span_y"]).to(torch.int64)
  by_depth = None
  if use_depth16 and config.deterministic:
    by_depth = torch.sort(depth, stable=True).indices
    counts = counts[by_depth]
  offsets = torch.cumsum(counts, 0) - counts
  with tracing.span("map.sync"):
    n_cand = int(counts.sum())                   # the one host sync
  gid = torch.repeat_interleave(
      torch.arange(n, device=device), counts, output_size=n_cand)
  j = torch.arange(n_cand, device=device) - offsets[gid]
  if by_depth is not None:
    gid = by_depth[gid]
  sx = fp["span_x"].to(torch.int64)[gid]
  ty = fp["ty0"][gid] + j // sx
  tx = fp["tx0"][gid] + j % sx
  lo_x = (tx * tile_size).to(points.dtype) - fp["mx"][gid]
  lo_y = (ty * tile_size).to(points.dtype) - fp["my"][gid]
  accept = _sat_accept(lo_x, lo_y, tuple(b[gid] for b in fp["ib"]), tile_size)

  # one stable sort on (tile, depth); rejected candidates sort last
  tile = torch.where(accept, (tx + ty * tw).to(torch.int64), n_tiles)
  if use_depth16:
    d16 = (torch.clamp(depth, 0.0, 1.0) * 65535.0).to(torch.int64)
    # (tile << 16 | d16) < 2**32; subtracting 2**31 maps its unsigned
    # order onto int32's signed order
    key = (((tile << 16) | d16[gid]) - 2 ** 31).to(torch.int32)
    key, order = torch.sort(key, stable=True)
    sorted_tile = ((key.to(torch.int64) + 2 ** 31) >> 16).to(torch.int32)
  else:
    depth_rank = torch.empty(n, dtype=torch.int64, device=device)
    depth_rank[torch.sort(depth, stable=True).indices] = torch.arange(
        n, device=device)
    key = (tile << 32) | depth_rank[gid]
    key, order = torch.sort(key, stable=True)
    sorted_tile = (key >> 32).to(torch.int32)
  overlap_to_point = torch.where(sorted_tile < n_tiles, gid[order], n).to(torch.int32)

  bounds = torch.searchsorted(
      sorted_tile, torch.arange(n_tiles + 1, dtype=torch.int32, device=device))
  tile_ranges = torch.stack([bounds[:-1], bounds[1:]], dim=1).to(torch.int32)

  return TileMapping(
      overlap_to_point=overlap_to_point,
      overlap_to_tile=sorted_tile,
      tile_ranges=tile_ranges,
      tile_shape=(th, tw),
      total_overlaps=bounds[-1],
      overflow=fp["clipped"],
      point_sentinel=n,
      point_offsets=point_offsets(overlap_to_point, n))
