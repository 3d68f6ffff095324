"""What the raster kernels' work is on a given frame, and the least time an
H100 could take for it.

`raster_work` counts, with the plain blend's arithmetic, the (pixel, slot)
pairs of a frame's tile bins up to where each pixel stops -- where its
saturation gate closes, or in quantile mode where its accumulated weight
reaches 1 - saturate_threshold (`evaluated`); those among them inside the
slot's threshold box, the pairs the kernels evaluate a pdf for (`boxed`);
and those whose alpha passes the threshold, the pairs that carry a weight
and a gradient (`active`). For a block layout of `ppt` pixels a thread it
also counts the (warp, slot) pairs where any pixel of the warp is
evaluated or active; the active ones pay a cross-lane reduction in the
backward kernel. The counts depend on the data, so a bound is computed
from the frame it is quoted for.

The `*_bound` functions turn the counts into the bound the kernels' times
are held against: the larger of the bytes the function must move (each
input read once, each output written once) over the card's memory rate and
its FP32 operations over the card's FP32 rate. Only the active pairs are
charged: the function needs the pdf, the blend and the gradient rows of
those pairs alone, whatever the kernels spend on the others. Operations
are counted per pair from the kernels' arithmetic (a fused multiply-add is
two, an exp, a log or a divide one), and a slot row adds one operation
for each active pair it sums. The rates are the published H100 SXM peaks
at 700 W (`PEAK_FP32_FLOPS`, `PEAK_BYTES_PER_S`).

`threshold_extent` mirrors the kernels' threshold box
(`csrc/raster_common.cuh`), so that the box can be held against the plain
pdf on the CPU.
"""

import math
from typing import Dict, Sequence, Tuple

import torch

from ...config import RasterConfig
from ..mapper import TileMapping
from .forward import _pdf_alpha
from .tiles import image_to_tiles

PEAK_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3

# FP32 operations per active pair: the pdf (keyed by antialias), the
# forward's gates, weight, T update and saturation test (F feature FMAs and
# one visibility add on top), and the backward's weight, D, C, dL/da and T
# (2F for D and 2F for the feature rows, the point rows, the two heuristic
# rows and the visibility row on top)
EVAL_OPS = {False: 15, True: 54}
FORWARD_ACTIVE_OPS = 9
BACKWARD_ACTIVE_OPS = 18
BACKWARD_POINT_ROW_OPS = {False: 20, True: 75}
BACKWARD_HEURISTIC_OPS = 8

# the antialiased box's constants (raster_common.cuh)
CDF_SLOPE = 0.404
CDF_SLACK = 5e-7
LOG_MARGIN = 1e-3

_BATCH_ELEMENTS = 1 << 24


def _cdf_tail_z(L: torch.Tensor) -> torch.Tensor:
  """The least z >= 0 with 1.6 z + 0.07 z^3 >= L, rounded up."""
  pos = L > 0
  L = torch.where(pos, L, torch.ones_like(L))
  z = torch.minimum(L / 1.6, torch.pow(L / 0.07, 1.0 / 3.0))
  for _ in range(3):
    z = z - (z * (1.6 + 0.07 * z * z) - L) / (1.6 + 0.21 * z * z)
  return torch.where(pos, 1.001 * z, torch.zeros_like(z))


def _antialias_half_extent(s, log_other, log_threshold):
  r = torch.exp(log_threshold - LOG_MARGIN - log_other - torch.log(s)) - CDF_SLACK
  ok = r > 0
  z = _cdf_tail_z(-torch.log(torch.where(ok, r, torch.ones_like(r))))
  return torch.where(ok, 0.5 + s * z, torch.full_like(s, math.inf))


def threshold_extent(points: torch.Tensor, alpha_threshold: float,
                     antialias: bool) -> Tuple[torch.Tensor, torch.Tensor]:
  """(hx, hy) half-extents (M,) of the packed points' (M, 7) threshold
  boxes around their means, in the points' dtype, by the kernels'
  formulas: outside the box no pixel's pre-gate alpha exceeds
  alpha_threshold. Negative culls every pixel, infinite or NaN none."""
  ax, ay, sx, sy, pa = (points[:, i] for i in range(2, 7))
  log_threshold = math.log(alpha_threshold) if alpha_threshold > 0 else -math.inf
  norm = ax * ax + ay * ay
  inf = torch.full_like(sx, math.inf)
  if antialias:
    log_ix = torch.log(torch.clamp(sx, max=CDF_SLOPE) + CDF_SLACK * sx)
    log_iy = torch.log(torch.clamp(sy, max=CDF_SLOPE) + CDF_SLACK * sy)
    log_peak = torch.log(2 * math.pi * pa)
    eu = _antialias_half_extent(sx, log_peak + log_iy, log_threshold)
    ev = _antialias_half_extent(sy, log_peak + log_ix, log_threshold)
    hx = 1.001 * (ax.abs() * eu + ay.abs() * ev) / norm + 0.01
    hy = 1.001 * (ay.abs() * eu + ax.abs() * ev) / norm + 0.01
    culled = log_peak + log_ix + log_iy < log_threshold - LOG_MARGIN
    hx = torch.where(culled, -torch.ones_like(hx), hx)
    hy = torch.where(culled, -torch.ones_like(hy), hy)
    valid = (pa > 0) & (sx > 0) & (sy > 0)
    return torch.where(valid, hx, inf), torch.where(valid, hy, inf)
  log_alpha = torch.clamp(torch.log(torch.clamp(pa, min=0.0)), min=-1e4)
  kappa = (torch.maximum(sx, sy) / torch.minimum(sx, sy)) ** 2
  c = 2.0 * (log_alpha - log_threshold + 1e-3) * (1.01 + 8e-6 * kappa)
  root = torch.sqrt(torch.clamp(c, min=0.0))
  hx = 1.001 * root * torch.sqrt(ax * ax * sx * sx + ay * ay * sy * sy) / norm + 0.01
  hy = 1.001 * root * torch.sqrt(ay * ay * sx * sx + ax * ax * sy * sy) / norm + 0.01
  hx = torch.where(c > 0, hx, -torch.ones_like(hx))
  hy = torch.where(c > 0, hy, -torch.ones_like(hy))
  bounded = kappa <= 1e5
  return torch.where(bounded, hx, inf), torch.where(bounded, hy, inf)


def warp_pixels(tile_size: int, ppt: int) -> torch.Tensor:
  """(warps, 32 * ppt) tile-local pixel indices (row-major) of each warp
  of the kernels' block layout: thread t owns column t % tile_size, rows
  (t // tile_size) * ppt + k for k < ppt (raster_common.cuh). ppt = 1 is
  one pixel a thread in row-major order."""
  p = tile_size * tile_size
  if p % (32 * ppt) or tile_size % ppt:
    raise ValueError(f"tile_size {tile_size} with {ppt} pixels a thread does "
                     "not make whole warps")
  t = torch.arange(p // ppt)
  k = torch.arange(ppt)
  pix = ((t // tile_size)[:, None] * ppt + k) * tile_size + (t % tile_size)[:, None]
  return pix.reshape(-1, 32 * ppt)


def raster_work(points: torch.Tensor, mapping: TileMapping,
                config: RasterConfig, image_size: Tuple[int, int],
                layouts: Sequence[int] = ()) -> Dict[str, int]:
  """Counts of the kernels' work on a frame in config's mode: `evaluated`,
  `boxed` and `active` (pixel, slot) pairs over the pixels inside the
  image, and for each ppt in `layouts` `warp_slots_{ppt}` (warp, slot)
  pairs where some pixel of the warp is evaluated and
  `active_warp_slots_{ppt}` where some pixel is active."""
  dtype, device = points.dtype, points.device
  ts = config.tile_size
  p = ts * ts
  th, tw = mapping.tile_shape
  ranges = mapping.tile_ranges.to(torch.int64)
  starts, counts = ranges[:, 0], ranges[:, 1] - ranges[:, 0]
  mb = max(int(counts.max()) if counts.numel() else 0, 1)
  sentinel = points.shape[0]
  k = mapping.overlap_to_point.shape[0]
  otp = torch.cat([mapping.overlap_to_point.to(torch.int64),
                   torch.full((1,), sentinel, dtype=torch.int64, device=device)])
  pts_pad = torch.cat(
      [points, torch.tensor([[0, 0, 1, 0, 1, 1, 0]], dtype=dtype, device=device)])
  hx_pad, hy_pad = threshold_extent(pts_pad, config.alpha_threshold,
                                    config.antialias)
  lin = torch.arange(p, device=device)
  cx = (lin % ts).to(dtype) + 0.5
  cy = (lin // ts).to(dtype) + 0.5
  w_img, h_img = image_size
  inside_t = image_to_tiles(points.new_ones(h_img, w_img, 1),
                            mapping.tile_shape, ts)[:, 0] > 0       # (T, P)
  warps = {ppt: warp_pixels(ts, ppt).to(device) for ppt in layouts}
  stop = (config.saturate_threshold if config.use_alpha_blending
          else 1 - config.saturate_threshold)

  out = {"evaluated": 0, "boxed": 0, "active": 0}
  for ppt in layouts:
    out[f"warp_slots_{ppt}"] = 0
    out[f"active_warp_slots_{ppt}"] = 0
  step = max(1, _BATCH_ELEMENTS // (p * mb))
  for b0 in range(0, th * tw, step):
    t = torch.arange(b0, min(b0 + step, th * tw), device=device)
    slot = starts[t, None] + torch.arange(mb, device=device)
    live = torch.arange(mb, device=device) < counts[t, None]
    idx = torch.where(live, otp[slot.clamp(max=k)], sentinel)
    ox = ((t % tw) * ts).to(dtype)
    oy = ((t // tw) * ts).to(dtype)
    pts = pts_pad[idx]
    a_raw = _pdf_alpha(pts, cx, cy, ox, oy, config.antialias)  # (B, P, M)
    thresh = a_raw > config.alpha_threshold
    a_eff = torch.where(thresh, torch.clamp(a_raw, max=config.clamp_max_alpha),
                        torch.zeros_like(a_raw))
    t_incl = torch.cumprod(1 - a_eff, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    evaluated = ((1 - t_excl) < stop) \
        & live[:, None, :] & inside_t[t][:, :, None]
    # the kernels' test: a pair is outside when either distance exceeds
    # its half-extent (a NaN extent keeps the pair)
    dx = (cx[None, :, None] - (pts[..., 0] - ox[:, None])[:, None, :]).abs()
    dy = (cy[None, :, None] - (pts[..., 1] - oy[:, None])[:, None, :]).abs()
    outside = (dx > hx_pad[idx][:, None, :]) | (dy > hy_pad[idx][:, None, :])
    active = evaluated & thresh
    out["evaluated"] += int(evaluated.sum())
    out["boxed"] += int((evaluated & ~outside).sum())
    out["active"] += int(active.sum())
    for ppt, pix in warps.items():
      out[f"warp_slots_{ppt}"] += int(evaluated[:, pix].any(2).sum())
      out[f"active_warp_slots_{ppt}"] += int(active[:, pix].any(2).sum())
  return out


def _bound(ops: float, nbytes: float) -> Dict[str, float]:
  t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
  return {"ops": ops, "bytes": nbytes, "ms": max(t_ops, t_bytes) * 1e3,
          "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def forward_bound(work: Dict[str, int], n_points: int, n_features: int,
                  n_slots: int, n_tiles: int, image_size: Tuple[int, int],
                  antialias: bool, visibility: bool = False) -> Dict[str, float]:
  """The forward kernel's bound: points (N, 7), features (N, F), the
  slots' indices and the tile ranges read once; the image, the weight and
  with `visibility` the per-slot visibility written once; the active
  pairs' pdf and blend."""
  f = n_features
  ops = work["active"] * (EVAL_OPS[antialias] + FORWARD_ACTIVE_OPS + 2 * f
                          + int(visibility))
  w, h = image_size
  nbytes = 4 * (n_points * (7 + f) + n_slots + 2 * n_tiles
                + w * h * (f + 1) + (n_slots if visibility else 0))
  return _bound(ops, nbytes)


def backward_bound(work: Dict[str, int], n_points: int, n_features: int,
                   n_slots: int, n_tiles: int, image_size: Tuple[int, int],
                   antialias: bool, heuristic: bool,
                   visibility: bool) -> Dict[str, float]:
  """The backward kernel's bound: points, features, the slots' indices,
  the tile ranges, the image, weight and their cotangents read once; the
  (R, K) slot rows written once; the active pairs' pdf, replay and rows."""
  f = n_features
  rows = ((7 if antialias else 6) + (2 if heuristic else 0)
          + int(visibility) + f)
  ops = work["active"] * (
      EVAL_OPS[antialias] + BACKWARD_ACTIVE_OPS + 4 * f
      + BACKWARD_POINT_ROW_OPS[antialias]
      + (BACKWARD_HEURISTIC_OPS if heuristic else 0) + int(visibility))
  w, h = image_size
  nbytes = 4 * (n_points * (7 + f) + n_slots + 2 * n_tiles
                + 2 * w * h * (f + 1) + rows * n_slots)
  return _bound(ops, nbytes)


def segment_sum_bound(rows: int, n_slots: int, n_points: int) -> Dict[str, float]:
  """The segment-sum kernel's bound: the (R, K) rows and the (N + 1,)
  offsets read once, the (R, N) sums written once; one add a value."""
  return _bound(rows * n_slots, 4 * (rows * n_slots + n_points + 1 + rows * n_points))
