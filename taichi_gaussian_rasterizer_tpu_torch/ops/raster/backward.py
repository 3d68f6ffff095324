"""Backward rasterizer: the CUDA kernel's wrapper and its plain PyTorch
version (port of `taichi_gaussian_rasterizer_tpu.ops.raster.backward`).

`rasterize_backward` is the one entry point. On a CUDA tensor it launches
the hand-written kernel `csrc/raster_backward.cu` (which replaces the TPU
kernel `taichi_gaussian_rasterizer_tpu/ops/raster/backward.py:
_backward_kernel`) or raises; on a CPU tensor it runs
`raster_backward_plain`. Nothing falls back from the kernel to the plain
version.

Both return the JAX kernel's per-slot rows, (R, K) over the mapping's K
overlap slots, always at full precision (never bf16 pairs), as a view of
slot-major storage (K, R), each slot's R values contiguous: the layout the
gradient reduction reads (`reduce.point_sums_by_order`). Indexed as (R, K),
the values are the JAX kernel's:

* point rows: 6 conic-transport rows d/d(mean_x, mean_y, qa, qb, qc,
  log_pa), or under antialias 7 eigen rows d/d(mean_x, mean_y, axis_x,
  axis_y, sigma_x, sigma_y, point_alpha);
* with compute_point_heuristic, 2 heuristic rows: prune cost, the sum of
  (dL/da_raw)^2 (conic; the pa^2 factor comes after the reduction) or of
  (pa dL/da_raw)^2 (antialias), and split score, the sum of the L1 norm of
  the alpha-weighted mean gradient;
* with vis_row, the visibility row: the sum of blend weights;
* F feature rows: the sum of grad_c * weight.

Each row is a sum over the slot's tile's pixels inside the image (pixels
of a partial edge tile past the image add nothing; the JAX kernel counts
them in the visibility row). dL/da_raw = gate * (T D - (E - C) / (1 - a))
(`blend.chunk_alpha_grads`), with D = sum_c feature_c grad_c plus the
weight image's cotangent as an all-ones feature, E = sum_c image_c
grad_c over the features and the weight channel, and C the inclusive
running sum of w * D. Slots the replay never reaches (past saturation,
past the real overlaps) hold 0. Blending mode only: the quantile mode
passes no gradient.
"""

from typing import Optional, Sequence

import torch

from ...config import RasterConfig
from ...utils.cuda_build import CudaKernel
from ..mapper import TileMapping
from .forward import _pdf_alpha, check_raster_shapes
from .tiles import image_to_tiles

RASTER_BACKWARD = CudaKernel("raster_backward.cu", "tgr_raster_backward", """
    f32 points, f32 features, i32 overlap_to_point, i32 tile_ranges,
    i32 tile_order, i32 tile_counter, f32 image, f32 weight, f32 grad_image,
    f32 grad_weight, int num_tiles, int tiles_x, int tile_size, int width,
    int height, int num_features, float alpha_threshold,
    float clamp_max_alpha, float saturate_threshold, int antialias,
    int heuristic, int visibility, f32 out""")

# elements of one (tiles, pixels, points) field the plain version
# materializes at a time; a dozen such fields are live at once
_PLAIN_BATCH_ELEMENTS = 1 << 24


def live_grad_rows(f: int, compute_point_heuristic: bool,
                   vis_row: bool = False, antialias: bool = False) -> int:
  """Point-parameter rows (7 eigen-form for antialias, 6 conic-transport
  otherwise) [+2 heuristics] [+1 visibility] + F feature rows."""
  return ((7 if antialias else 6)
          + (2 if compute_point_heuristic else 0) + int(vis_row) + f)


def _antialias_partials(dx, dy, ax, ay, sx, sy):
  """The box-integrated pdf and its partials wrt mean, axis and sigma
  (`blend.chunk_pdf_with_grads`, antialias branch)."""
  def s_grad(x, s):
    z = x / s
    sig = torch.sigmoid(1.6 * z + 0.07 * z * z * z)
    ds_dz = (1.6 + 0.21 * z * z) * sig * (1 - sig)
    return sig, ds_dz / s, -(ds_dz / s) * z    # S, dS/dx, dS/dsigma

  tau = 2.0 * torch.pi
  tu = dx * ax + dy * ay
  tv = dy * ax - dx * ay
  sx1, dsx1, dsx1_s = s_grad(tu + 0.5, sx)
  sx2, dsx2, dsx2_s = s_grad(tu - 0.5, sx)
  sy1, dsy1, dsy1_s = s_grad(tv + 0.5, sy)
  sy2, dsy2, dsy2_s = s_grad(tv - 0.5, sy)
  ix = sx * (sx1 - sx2)
  iy = sy * (sy1 - sy2)
  dpx = tau * iy * sx * (dsx1 - dsx2)     # dp/dtu
  dpy = tau * ix * sy * (dsy1 - dsy2)     # dp/dtv
  return (tau * ix * iy,
          -(dpx * ax - dpy * ay),
          -(dpx * ay + dpy * ax),
          dpx * dx + dpy * dy,
          dpx * dy - dpy * dx,
          tau * iy * (sx1 - sx2 + (dsx1_s - dsx2_s) * sx),
          tau * ix * (sy1 - sy2 + (dsy1_s - dsy2_s) * sy))


def raster_backward_plain(points: torch.Tensor, features: torch.Tensor,
                          mapping: TileMapping, config: RasterConfig,
                          image: torch.Tensor, weight: torch.Tensor,
                          grad_image: torch.Tensor, grad_weight: torch.Tensor,
                          compute_point_heuristic: bool = False,
                          vis_row: bool = False,
                          tile_ids: Optional[Sequence[int]] = None
                          ) -> torch.Tensor:
  """Plain PyTorch backward over whole tile bins.

  image (H, W, F) and weight (H, W) are the forward's outputs, grad_image
  and grad_weight their cotangents. Each bin is gathered into (tiles,
  pixels, points) fields, as in `rasterize_tiles_plain`; the transmittance
  is its exclusive cumulative product and C a cumulative sum. `tile_ids`
  selects a subset of tiles (default: all); slots of other tiles hold 0.

  Returns the (R, K) per-slot rows described in the module docstring, a
  view of slot-major storage.
  """
  dtype, device = points.dtype, points.device
  f = features.shape[1]
  ts = config.tile_size
  p = ts * ts
  th, tw = mapping.tile_shape
  tiles = (torch.arange(th * tw, device=device) if tile_ids is None
           else torch.as_tensor(tile_ids, dtype=torch.int64, device=device))
  ranges = mapping.tile_ranges[tiles].to(torch.int64)
  starts, counts = ranges[:, 0], ranges[:, 1] - ranges[:, 0]
  mb = max(int(counts.max()) if len(tiles) else 0, 1)
  sentinel = points.shape[0]
  k = mapping.overlap_to_point.shape[0]
  otp = torch.cat([mapping.overlap_to_point.to(torch.int64),
                   torch.full((1,), sentinel, dtype=torch.int64, device=device)])

  lin = torch.arange(p, device=device)
  cx = (lin % ts).to(dtype) + 0.5
  cy = (lin // ts).to(dtype) + 0.5
  pts_pad = torch.cat(
      [points, torch.tensor([[0, 0, 1, 0, 1, 1, 0]], dtype=dtype, device=device)])
  # features with the weight image's all-ones channel; sentinel row 0
  feats_pad = torch.cat([
      torch.cat([features, features.new_ones(features.shape[0], 1)], 1),
      features.new_zeros(1, f + 1)])

  # (T, F + 1, P) image and cotangent with the weight as channel F
  img_t = image_to_tiles(torch.cat([image, weight[..., None]], -1),
                         mapping.tile_shape, ts)
  grad_t = image_to_tiles(torch.cat([grad_image, grad_weight[..., None]], -1),
                          mapping.tile_shape, ts)
  inside_t = image_to_tiles(image.new_ones(*weight.shape, 1),
                            mapping.tile_shape, ts)[:, 0]
  e_t = (img_t * grad_t).sum(1)                             # (T, P)

  rows = live_grad_rows(f, compute_point_heuristic, vis_row, config.antialias)
  out = points.new_zeros(k, rows)
  step = max(1, _PLAIN_BATCH_ELEMENTS // (p * mb))
  for b0 in range(0, len(tiles), step):
    t = tiles[b0:b0 + step]
    slot = starts[b0:b0 + step, None] + torch.arange(mb, device=device)
    live = torch.arange(mb, device=device) < counts[b0:b0 + step, None]
    idx = torch.where(live, otp[slot.clamp(max=k)], sentinel)
    ox = ((t % tw) * ts).to(dtype)
    oy = ((t // tw) * ts).to(dtype)
    pts = pts_pad[idx]                                      # (B, M, 7)

    a_raw = _pdf_alpha(pts, cx, cy, ox, oy, config.antialias)   # (B, P, M)
    thresh_ok = a_raw > config.alpha_threshold
    a_eff = torch.where(thresh_ok, torch.clamp(a_raw, max=config.clamp_max_alpha),
                        torch.zeros_like(a_raw))
    t_incl = torch.cumprod(1 - a_eff, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
    sat_ok = (1 - t_excl) < config.saturate_threshold
    w = a_eff * t_excl * sat_ok
    gate = thresh_ok & (a_raw < config.clamp_max_alpha) & sat_ok

    g = grad_t[t]                                           # (B, F + 1, P)
    d = torch.einsum("bmf,bfp->bpm", feats_pad[idx], g)
    c_incl = torch.cumsum(w * d, dim=-1)
    dl = torch.where(gate, t_excl * d - (e_t[t][..., None] - c_incl) / (1 - a_eff),
                     torch.zeros_like(a_raw))

    # tile-local pair geometry, d = pixel - mean
    dx = cx[None, :, None] - (pts[..., 0] - ox[:, None])[:, None, :]
    dy = cy[None, :, None] - (pts[..., 1] - oy[:, None])[:, None, :]
    ax, ay = pts[..., 2][:, None, :], pts[..., 3][:, None, :]
    sx, sy = pts[..., 4][:, None, :], pts[..., 5][:, None, :]
    if config.antialias:
      pdf, d_mx, d_my, d_ax, d_ay, d_sx, d_sy = _antialias_partials(
          dx, dy, ax, ay, sx, sy)
      d_pdf = dl * pts[..., 6][:, None, :]
      fields = [d_pdf * d_mx, d_pdf * d_my, d_pdf * d_ax, d_pdf * d_ay,
                d_pdf * d_sx, d_pdf * d_sy, dl * pdf]
      if compute_point_heuristic:
        fields += [d_pdf * d_pdf, (d_pdf * d_mx).abs() + (d_pdf * d_my).abs()]
    else:
      isx2, isy2 = 1.0 / (sx * sx), 1.0 / (sy * sy)
      qa = ax * ax * isx2 + ay * ay * isy2
      qb = ax * ay * (isx2 - isy2)
      qc = ay * ay * isx2 + ax * ax * isy2
      b = dl * a_raw
      qx, qy = qa * dx + qb * dy, qb * dx + qc * dy
      fields = [b * qx, b * qy, -0.5 * b * dx * dx, -b * dx * dy,
                -0.5 * b * dy * dy, b]
      if compute_point_heuristic:
        fields += [dl * dl, (b * qx).abs() + (b * qy).abs()]
    sums = [x.sum(1) for x in fields]                       # (B, M) each
    if vis_row:
      sums.append(torch.einsum("bp,bpm->bm", inside_t[t], w))
    block = torch.cat([torch.stack(sums),                  # (R, B, M)
                       torch.einsum("bfp,bpm->fbm", g[:, :f], w)])
    out[slot[live]] = block[:, live].T
  return out.T


def raster_backward_cuda(points: torch.Tensor, features: torch.Tensor,
                         mapping: TileMapping, config: RasterConfig,
                         image: torch.Tensor, weight: torch.Tensor,
                         grad_image: torch.Tensor, grad_weight: torch.Tensor,
                         compute_point_heuristic: bool = False,
                         vis_row: bool = False) -> torch.Tensor:
  """Launch the CUDA kernel: float32 only, (N, F) features of any width
  F >= 1 (past 16 channels, one replay of each tile, the channel sums D
  and the feature rows as products of a batch), any tile_size >= 1 (a
  tile larger than a block is covered in pixel chunks). Returns the (R, K)
  slot rows, a view of the (K, R) storage the kernel writes."""
  check_raster_shapes(points, features, config)
  h, w = weight.shape
  for name, t, shape in (("image", image, (h, w, features.shape[1])),
                         ("grad_image", grad_image, (h, w, features.shape[1])),
                         ("grad_weight", grad_weight, (h, w))):
    if tuple(t.shape) != shape:
      raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
  th, tw = mapping.tile_shape
  k = mapping.overlap_to_point.shape[0]
  rows = live_grad_rows(features.shape[1], compute_point_heuristic, vis_row,
                        config.antialias)
  out = torch.zeros((k, rows), dtype=torch.float32, device=points.device)
  counter = torch.empty(1, dtype=torch.int32, device=points.device)
  RASTER_BACKWARD.launch(
      points, features, mapping.overlap_to_point, mapping.tile_ranges,
      mapping.tile_order, counter, image, weight, grad_image, grad_weight,
      th * tw, tw, config.tile_size, w, h, features.shape[1],
      config.alpha_threshold, config.clamp_max_alpha, config.saturate_threshold,
      config.antialias, compute_point_heuristic, vis_row, out)
  return out.T


def rasterize_backward(points: torch.Tensor, features: torch.Tensor,
                       mapping: TileMapping, config: RasterConfig,
                       image: torch.Tensor, weight: torch.Tensor,
                       grad_image: torch.Tensor, grad_weight: torch.Tensor,
                       compute_point_heuristic: bool = False,
                       vis_row: bool = False) -> torch.Tensor:
  """(R, K) per-slot gradient rows, a view of slot-major (K, R) storage:
  the CUDA kernel for CUDA tensors, the plain version for CPU tensors. A
  non-float32 CUDA input raises."""
  args = (points, features, mapping, config, image, weight, grad_image,
          grad_weight, compute_point_heuristic, vis_row)
  if points.is_cuda:
    return raster_backward_cuda(*args)
  if points.device.type != "cpu":
    raise ValueError(f"no backward rasterizer for device {points.device}")
  return raster_backward_plain(*args)
