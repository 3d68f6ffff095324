"""Forward rasterizer: the CUDA kernel's wrapper and its plain PyTorch version.

`rasterize_forward` is the one entry point. On a CUDA tensor it launches
the hand-written kernel `csrc/raster_forward.cu` (which replaces the TPU
kernel `taichi_gaussian_rasterizer_tpu/ops/raster/forward.py:_forward_kernel`)
or raises; on a CPU tensor it runs `rasterize_tiles_plain`, the same blend
written as straight tensor code over each tile's bin, which autograd
differentiates. Nothing falls back from the kernel to the plain version.
With `compute_visibility` both also return the per-slot visibility (K,):
each overlap slot's weight summed over its tile's pixels inside the image
(the JAX kernel also counts a partial edge tile's pixels past the image),
so that the per-point sums add up to the weight image.
With `tile_front` both also return the per-tile saturation front (T,)
int32 that saturation-front truncation reads (`function.py`): +(s + 1)
when every pixel of the tile inside the image has stopped, s the largest
tile-local slot index at which one of them closed its saturation gate;
-(bin length) when some pixel ran out of its bin unsaturated; 0 for an
empty bin. It is the counterpart of the JAX kernel's signed `satiters`
counted in slots rather than chunks. The JAX kernel also waits for a
partial edge tile's pixels past the image, so there the port's front can
be shorter than JAX's, never longer.

Blend semantics are the JAX package's (`blend.chunk_weights_raw`), which
differ from the Taichi reference's forward:

* alpha = point_alpha * pdf, gated to 0 unless > alpha_threshold and
  clamped at clamp_max_alpha;
* the blend weight a * T is gated on 1 - T < saturate_threshold (the
  accumulated weight before the point);
* quantile (non-blending) mode weights the point whose accumulated weight
  crosses c = 1 - saturate_threshold with 1, and the weight image is
  (sum of a * T > 0);
* the conic pdf is exp(log pa - d^T Q d / 2) with Q from the eigen form;
  the antialiased pdf is the box-integrated sigmoid-CDF form. Pixel and
  mean coordinates are tile-local, as in the JAX kernels.
"""

from typing import Optional, Sequence, Tuple

import torch

from ...config import RasterConfig
from ...utils.cuda_build import CudaKernel
from ..mapper import TileMapping
from .tiles import image_to_tiles, tiles_to_image

RASTER_FORWARD = CudaKernel("raster_forward.cu", "tgr_raster_forward", """
    f32 points, f32 features, i32 overlap_to_point, i32 tile_ranges,
    i32 tile_order, i32 tile_counter, int num_tiles, int tiles_x,
    int tile_size, int width, int height, int num_features,
    float alpha_threshold, float clamp_max_alpha, float saturate_threshold,
    int antialias, int blending, f32 image, f32 weight, f32? visibility,
    i32? tile_front""")

# elements of one (tiles, pixels, points) field the plain version
# materializes at a time; bounds its memory on large frames
_PLAIN_BATCH_ELEMENTS = 1 << 25


def _pdf_alpha(pts: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
               ox: torch.Tensor, oy: torch.Tensor, antialias: bool):
  """Pre-gate alpha point_alpha * pdf of every (tile, pixel, point) triple.

  pts: (B, M, 7) packed bin points; cx, cy: (P,) tile-local pixel centres;
  ox, oy: (B,) tile origins. Returns (B, P, M)."""
  mx = (pts[..., 0] - ox[:, None])[:, None, :]      # (B, 1, M) tile-local
  my = (pts[..., 1] - oy[:, None])[:, None, :]
  ax, ay = pts[..., 2][:, None, :], pts[..., 3][:, None, :]
  sx, sy = pts[..., 4][:, None, :], pts[..., 5][:, None, :]
  pa = pts[..., 6][:, None, :]
  dx = cx[None, :, None] - mx
  dy = cy[None, :, None] - my
  if antialias:
    def cdf(x, s):
      z = x / s
      return torch.sigmoid(1.6 * z + 0.07 * z * z * z)

    tu = dx * ax + dy * ay
    tv = dy * ax - dx * ay
    ix = sx * (cdf(tu + 0.5, sx) - cdf(tu - 0.5, sx))
    iy = sy * (cdf(tv + 0.5, sy) - cdf(tv - 0.5, sy))
    return pa * (2.0 * torch.pi * ix * iy)
  isx2 = 1.0 / (sx * sx)
  isy2 = 1.0 / (sy * sy)
  qa = ax * ax * isx2 + ay * ay * isy2
  qb = ax * ay * (isx2 - isy2)
  qc = ay * ay * isx2 + ax * ax * isy2
  log_pa = torch.clamp(torch.log(torch.clamp(pa, min=0.0)), min=-1e4)
  return torch.exp(log_pa - 0.5 * (qa * dx * dx + 2.0 * qb * dx * dy + qc * dy * dy))


def rasterize_tiles_plain(points: torch.Tensor, features: torch.Tensor,
                          mapping: TileMapping, config: RasterConfig,
                          tile_ids: Optional[Sequence[int]] = None,
                          visibility_image_size: Optional[Tuple[int, int]] = None,
                          front_image_size: Optional[Tuple[int, int]] = None):
  """Plain PyTorch forward over whole tile bins.

  Each bin is gathered into a (tiles, pixels, points) field; the
  transmittance before each point is an exclusive cumulative product of
  (1 - a). `tile_ids` selects a subset of tiles (default: all).

  Returns tile-packed (image (T', F, P), weight (T', P)) for the selected
  tiles, in `tile_ids` order. With `visibility_image_size` (width,
  height) it also returns the per-slot visibility (K,): each slot's weight
  summed over the pixels of its tile inside that image (0 for slots of
  unselected tiles and past the real overlaps). With `front_image_size`
  it also returns, last, the selected tiles' saturation fronts (T',) int32
  (module docstring) over the pixels inside that image: a pixel stops at
  the first slot after which its accumulated weight 1 - T has reached
  the stop threshold.
  """
  dtype, device = points.dtype, points.device
  f = features.shape[1]
  ts = config.tile_size
  p = ts * ts
  th, tw = mapping.tile_shape
  if tile_ids is None:
    tiles = torch.arange(th * tw, device=device)
  else:
    tiles = torch.as_tensor(tile_ids, dtype=torch.int64, device=device)
  ranges = mapping.tile_ranges[tiles].to(torch.int64)
  starts, counts = ranges[:, 0], ranges[:, 1] - ranges[:, 0]
  mb = max(int(counts.max()) if len(tiles) else 0, 1)
  sentinel = points.shape[0]
  k = mapping.overlap_to_point.shape[0]
  # one trailing sentinel slot keeps the bin gather in bounds
  otp = torch.cat([mapping.overlap_to_point.to(torch.int64),
                   torch.full((1,), sentinel, dtype=torch.int64, device=device)])

  lin = torch.arange(p, device=device)
  cx = (lin % ts).to(dtype) + 0.5
  cy = (lin // ts).to(dtype) + 0.5
  # sentinel row N: zero alpha, unit axis and sigma -- an exact no-op
  pts_pad = torch.cat(
      [points, torch.tensor([[0, 0, 1, 0, 1, 1, 0]], dtype=dtype, device=device)])
  feats_pad = torch.cat([features, features.new_zeros(1, f)])
  c = 1 - config.saturate_threshold
  vis = None
  if visibility_image_size is not None:
    w_img, h_img = visibility_image_size
    inside_t = image_to_tiles(points.new_ones(h_img, w_img, 1),
                              mapping.tile_shape, ts)[:, 0]       # (T, P)
    vis = points.new_zeros(k)
  if front_image_size is not None:
    w_img, h_img = front_image_size
    front_inside = image_to_tiles(points.new_ones(h_img, w_img, 1),
                                  mapping.tile_shape, ts)[:, 0] > 0  # (T, P)
  stop = config.saturate_threshold if config.use_alpha_blending else c

  images, weights, fronts = [], [], []
  step = max(1, _PLAIN_BATCH_ELEMENTS // (p * mb))
  for b0 in range(0, len(tiles), step):
    t = tiles[b0:b0 + step]
    slot = starts[b0:b0 + step, None] + torch.arange(mb, device=device)
    live = torch.arange(mb, device=device) < counts[b0:b0 + step, None]
    idx = torch.where(live, otp[slot.clamp(max=k)], sentinel)
    ox = ((t % tw) * ts).to(dtype)
    oy = ((t // tw) * ts).to(dtype)

    a_raw = _pdf_alpha(pts_pad[idx], cx, cy, ox, oy, config.antialias)
    a_eff = torch.where(a_raw > config.alpha_threshold,
                        torch.clamp(a_raw, max=config.clamp_max_alpha),
                        torch.zeros_like(a_raw))
    t_incl = torch.cumprod(1 - a_eff, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
    total_before = 1 - t_excl
    if config.use_alpha_blending:
      w = a_eff * t_excl * (total_before < config.saturate_threshold)
      alpha = w.sum(-1)
    else:
      total_after = 1 - t_excl * (1 - a_eff)
      w = ((total_before < c) & (total_after >= c)).to(dtype)
      alpha = (a_eff * t_excl).sum(-1)
    images.append(torch.einsum("bpm,bmf->bfp", w, feats_pad[idx]))
    weights.append(alpha if config.use_alpha_blending else (alpha > 0).to(dtype))
    if vis is not None:
      vis[slot[live]] = torch.einsum("bp,bpm->bm", inside_t[t], w)[live]
    if front_image_size is not None:
      fronts.append(_tile_fronts(t_incl, stop, front_inside[t],
                                 counts[b0:b0 + step]))

  if not images:
    image, weight = points.new_zeros(0, f, p), points.new_zeros(0, p)
  else:
    image, weight = torch.cat(images), torch.cat(weights)
  out = (image, weight) + (() if vis is None else (vis,))
  if front_image_size is not None:
    out += (torch.cat(fronts) if fronts
            else torch.zeros(0, dtype=torch.int32, device=device),)
  return out


def _tile_fronts(t_incl: torch.Tensor, stop: float, inside: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
  """Saturation fronts (B,) int32 of a batch of tiles from the inclusive
  transmittance (B, P, M), the in-image pixel mask (B, P) and the bin
  lengths (B,)."""
  closed = ~((1 - t_incl) < stop)                 # gate closed after the slot
  has_stop = closed.any(-1)
  first = closed.to(torch.int32).argmax(-1)       # first slot that closed it
  saturated = (has_stop | ~inside).all(-1)
  last = torch.where(inside & has_stop, first, -1).amax(-1)
  front = torch.where(saturated, last + 1, -counts)
  return torch.where(counts > 0, front, 0).to(torch.int32)


def check_raster_shapes(points: torch.Tensor, features: torch.Tensor,
                        config: RasterConfig) -> None:
  """The shapes both raster kernels take: (N, 7) points, (N, F) features
  with F >= 1, tile_size >= 1."""
  if points.ndim != 2 or points.shape[1] != 7:
    raise ValueError(f"points must be (N, 7), got {tuple(points.shape)}")
  if (features.ndim != 2 or features.shape[1] < 1
      or features.shape[0] != points.shape[0]):
    raise ValueError(f"the CUDA raster kernels take (N, F) features with "
                     f"1 <= F, got {tuple(features.shape)}")
  if config.tile_size < 1:
    raise ValueError(f"tile_size {config.tile_size}: a tile is at least one pixel")


def rasterize_tiles_cuda(points: torch.Tensor, features: torch.Tensor,
                         mapping: TileMapping, image_size: Tuple[int, int],
                         config: RasterConfig, compute_visibility: bool = False,
                         tile_front: bool = False):
  """Launch the CUDA kernel: float32 only, (N, F) features of any width
  F >= 1 (past 16 channels, one replay of each tile a chunk of up to 48
  channels, the channel sums as products of a batch), any tile_size >= 1
  (a tile larger than a block is covered in pixel chunks). Returns (image
  (H, W, F), weight (H, W)) [+ per-slot visibility (K,)] [+ saturation
  front (T,)]."""
  check_raster_shapes(points, features, config)
  w, h = image_size
  th, tw = mapping.tile_shape
  image = torch.empty((h, w, features.shape[1]), dtype=torch.float32,
                      device=points.device)
  weight = torch.empty((h, w), dtype=torch.float32, device=points.device)
  vis = (torch.zeros(mapping.overlap_to_point.shape, dtype=torch.float32,
                     device=points.device) if compute_visibility else None)
  front = (torch.empty(th * tw, dtype=torch.int32, device=points.device)
           if tile_front else None)
  counter = torch.empty(1, dtype=torch.int32, device=points.device)
  RASTER_FORWARD.launch(
      points, features, mapping.overlap_to_point, mapping.tile_ranges,
      mapping.tile_order, counter, th * tw, tw, config.tile_size, w, h,
      features.shape[1], config.alpha_threshold, config.clamp_max_alpha,
      config.saturate_threshold, config.antialias, config.use_alpha_blending,
      image, weight, vis, front)
  return ((image, weight) + (() if vis is None else (vis,))
          + (() if front is None else (front,)))


def rasterize_forward(points: torch.Tensor, features: torch.Tensor,
                      mapping: TileMapping, image_size: Tuple[int, int],
                      config: RasterConfig, compute_visibility: bool = False,
                      tile_front: bool = False):
  """(image (H, W, F), weight (H, W)), then with compute_visibility the
  per-slot visibility (K,), then with tile_front the per-tile saturation
  front (T,) int32 (blending configs only): the CUDA kernel for CUDA
  tensors, the plain version for CPU tensors. A non-float32 CUDA input
  raises."""
  if tile_front and not config.use_alpha_blending:
    raise ValueError("a non-blending (quantile) config has no saturation front")
  if points.is_cuda:
    return rasterize_tiles_cuda(points, features, mapping, image_size, config,
                                compute_visibility, tile_front)
  if points.device.type != "cpu":
    raise ValueError(f"no forward rasterizer for device {points.device}")
  image, weight, *extra = rasterize_tiles_plain(
      points, features, mapping, config,
      visibility_image_size=image_size if compute_visibility else None,
      front_image_size=image_size if tile_front else None)
  ts = config.tile_size
  return (tiles_to_image(image, mapping.tile_shape, ts, image_size),
          tiles_to_image(weight[:, None, :], mapping.tile_shape, ts, image_size)[..., 0],
          *extra)
