"""The raster kernels' tile queue order, block layout, threshold box and
work counts (`ops/mapper.longest_first`, `ops/raster/bounds`) against
plain references: loops, and the plain pdf on a pixel grid. CPU only;
float64 work counts."""

import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import (
    longest_first, map_to_tiles)
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import bounds
from taichi_gaussian_rasterizer_tpu_torch.ops.raster.forward import _pdf_alpha

import torch_port_scenes as scenes


def test_longest_first_is_a_stable_descending_order():
  rng = np.random.default_rng(0)
  lengths = rng.integers(0, 6, size=200)          # many ties, empty bins
  ends = np.cumsum(lengths)
  ranges = torch.tensor(np.stack([ends - lengths, ends], 1), dtype=torch.int32)
  got = longest_first(ranges)
  assert got.dtype == torch.int32
  want = sorted(range(len(lengths)), key=lambda t: (-lengths[t], t))
  assert got.tolist() == want


def test_mapping_keeps_its_tile_order():
  """map_to_tiles' mapping computes its queue order once."""
  size = (44, 28)
  config = RasterConfig(tile_size=8)
  p, depth, _ = scenes.points2d(12, 60, size)
  mapping = map_to_tiles(torch.tensor(p, dtype=torch.float32),
                         torch.tensor(depth, dtype=torch.float32), size, config)
  order = mapping.tile_order
  assert order is mapping.tile_order
  assert torch.equal(order, longest_first(mapping.tile_ranges))


@pytest.mark.parametrize("tile_size,ppt", [(8, 1), (8, 2), (16, 2), (16, 4),
                                           (32, 4)])
def test_warp_pixels_follow_the_block_layout(tile_size, ppt):
  """Thread t owns column t % ts, rows (t // ts) * ppt + k; a warp is 32
  consecutive threads; every pixel belongs to exactly one warp."""
  got = bounds.warp_pixels(tile_size, ppt)
  threads = tile_size * tile_size // ppt
  want = [[((t // tile_size) * ppt + k) * tile_size + t % tile_size
           for t in range(w * 32, w * 32 + 32) for k in range(ppt)]
          for w in range(threads // 32)]
  assert got.tolist() == want
  assert sorted(got.flatten().tolist()) == list(range(tile_size * tile_size))


def test_warp_pixels_refuses_partial_warps():
  with pytest.raises(ValueError, match="whole warps"):
    bounds.warp_pixels(8, 4)


def _splats(seed, m, antialias, threshold):
  """m packed points (float64) around the origin: random axes, sigmas
  log-uniform in [0.05, 25] on each axis (thin splats up to 500:1), and
  point alphas that put the peak alpha at 0.8-1.3 times the threshold
  (culled or barely passing) for two thirds of them, 5-300 times for the
  rest."""
  rng = np.random.default_rng(seed)
  mean = rng.uniform(-0.5, 0.5, size=(m, 2))
  theta = rng.uniform(0, np.pi, size=m)
  sigma = np.exp(rng.uniform(np.log(0.05), np.log(25.0), size=(m, 2)))
  pts = torch.tensor(np.concatenate(
      [mean, np.cos(theta)[:, None], np.sin(theta)[:, None], sigma,
       np.ones((m, 1))], 1))
  zero = torch.zeros(1, dtype=torch.float64)
  peak = _pdf_alpha(pts[None], pts[:, 0], pts[:, 1], zero, zero,
                    antialias)[0].diagonal()
  scale = rng.uniform(0.8, 1.3, size=m)
  scale[: m // 3] = rng.uniform(5.0, 300.0, size=m // 3)
  pts[:, 6] = torch.clamp(threshold * torch.tensor(scale) / peak, max=1.0)
  return pts


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("antialias", [False, True])
def test_threshold_box_holds_every_pixel_above_threshold(antialias, dtype):
  """No pixel of a 200 x 200 grid whose plain pre-gate alpha exceeds the
  threshold lies outside its point's box (the kernels skip exactly the
  pairs outside it), on thin and near-threshold splats; the box culls the
  points whose peak is below the threshold and stays within a few times
  the pixels it must hold."""
  threshold = 1.0 / 255.0
  pts = _splats(0, 300, antialias, threshold).to(dtype)
  grid = torch.arange(-100, 100, dtype=dtype) + 0.5
  cx, cy = grid.repeat(200), grid.repeat_interleave(200)
  zero = torch.zeros(1, dtype=dtype)
  above = _pdf_alpha(pts[None], cx, cy, zero, zero, antialias)[0] > threshold
  hx, hy = bounds.threshold_extent(pts, threshold, antialias)
  outside = ((cx[:, None] - pts[:, 0]).abs() > hx) \
      | ((cy[:, None] - pts[:, 1]).abs() > hy)
  assert not (above & outside).any()
  culled = hx < 0
  assert culled.any() and not above[:, culled].any()
  assert torch.isfinite(hx[~culled]).float().mean() > 0.95
  assert int((~outside).sum()) < 12 * int(above.sum())


def test_threshold_box_leaves_degenerate_points_unbounded():
  """A zero sigma or point alpha, or a conic past the conditioning limit,
  culls no pixel: the kernels then evaluate every pair, which is exact."""
  pts = torch.tensor([[0, 0, 1, 0, 0.0, 1.0, 0.5],
                      [0, 0, 1, 0, 1.0, 1.0, 0.0],
                      [0, 0, 1, 0, 1000.0, 1.0, 0.5]], dtype=torch.float32)
  hx, _ = bounds.threshold_extent(pts, 1.0 / 255.0, antialias=True)
  assert torch.isinf(hx[:2]).all()
  hx, _ = bounds.threshold_extent(pts, 1.0 / 255.0, antialias=False)
  assert torch.isinf(hx[2]) and hx[1] < 0


def _work_by_loops(points, mapping, config, size, layouts):
  """Each pixel's blend run slot by slot: a pixel evaluates a slot while
  1 - T < saturate_threshold (1 - saturate_threshold in quantile mode),
  is boxed where it lies inside the slot's threshold box and is active
  where alpha passes the threshold; a warp-slot counts where any of its
  pixels does."""
  stop = (config.saturate_threshold if config.use_alpha_blending
          else 1 - config.saturate_threshold)
  ts = config.tile_size
  th, tw = mapping.tile_shape
  w_img, h_img = size
  pts = points.numpy()
  otp = mapping.overlap_to_point.numpy()
  hx, hy = bounds.threshold_extent(points, config.alpha_threshold,
                                   config.antialias)
  out = {"evaluated": 0, "boxed": 0, "active": 0}
  warps = {ppt: bounds.warp_pixels(ts, ppt).tolist() for ppt in layouts}
  for ppt in layouts:
    out[f"warp_slots_{ppt}"] = out[f"active_warp_slots_{ppt}"] = 0
  for tile in range(th * tw):
    start, end = mapping.tile_ranges[tile].tolist()
    ox, oy = (tile % tw) * ts, (tile // tw) * ts
    ev = np.zeros((ts * ts, end - start), bool)
    ac = np.zeros_like(ev)
    for p in range(ts * ts):
      lx, ly = p % ts, p // ts
      if ox + lx >= w_img or oy + ly >= h_img:
        continue
      T = 1.0
      for j in range(end - start):
        if not 1 - T < stop:
          break
        ev[p, j] = True
        i = otp[start + j]
        mx, my, ax, ay, sx, sy, pa = pts[i]
        dx, dy = lx + 0.5 - (mx - ox), ly + 0.5 - (my - oy)
        if abs(dx) <= hx[i] and abs(dy) <= hy[i]:
          out["boxed"] += 1
        u = (dx * ax + dy * ay) / sx
        v = (dy * ax - dx * ay) / sy
        a_raw = np.exp(np.log(pa) - 0.5 * (u * u + v * v))
        if a_raw > config.alpha_threshold:
          ac[p, j] = True
          T *= 1 - min(a_raw, config.clamp_max_alpha)
    out["evaluated"] += int(ev.sum())
    out["active"] += int(ac.sum())
    for ppt, ws in warps.items():
      for pix in ws:
        out[f"warp_slots_{ppt}"] += int(ev[pix].any(0).sum())
        out[f"active_warp_slots_{ppt}"] += int(ac[pix].any(0).sum())
  return out


@pytest.mark.parametrize("blending", [True, False])
@pytest.mark.parametrize("alpha_range", [(0.1, 0.6), (0.7, 0.99)])
def test_raster_work_matches_loops(alpha_range, blending):
  """Translucent and saturating scenes, blending and quantile mode, a
  partial edge tile (44 x 28 in 8 x 8 tiles), float64."""
  size = (44, 28)
  config = RasterConfig(tile_size=8, use_alpha_blending=blending)
  p, depth, _ = scenes.points2d(11, 80, size, sigma_range=(0.8, 5.0),
                                alpha_range=alpha_range)
  points = torch.tensor(p, dtype=torch.float64)
  mapping = map_to_tiles(points, torch.tensor(depth), size, config)
  got = bounds.raster_work(points, mapping, config, size, layouts=(1, 2))
  assert got == _work_by_loops(points, mapping, config, size, (1, 2))
  assert 0 < got["active"] < got["boxed"] < got["evaluated"]


def test_bounds_pick_the_larger_time():
  """Only the active pairs cost operations: the pairs below the threshold
  are work of the kernels, not of the function."""
  work = {"evaluated": 10**9, "boxed": 3 * 10**8, "active": 10**8}
  fwd = bounds.forward_bound(work, 10**6, 3, 3 * 10**6, 12288, (2048, 1536),
                             antialias=False)
  ops = 10**8 * (bounds.EVAL_OPS[False] + bounds.FORWARD_ACTIVE_OPS + 6)
  assert fwd["ops"] == ops and fwd["bound_by"] == "operations"
  assert bounds.forward_bound({**work, "evaluated": 10**10, "boxed": 10**9},
                              10**6, 3, 3 * 10**6, 12288, (2048, 1536),
                              antialias=False) == fwd
  assert fwd["ms"] == pytest.approx(ops / bounds.PEAK_FP32_FLOPS * 1e3)
  seg = bounds.segment_sum_bound(9, 3 * 10**6, 10**6)
  assert seg["bound_by"] == "bytes"
  assert seg["ms"] == pytest.approx(seg["bytes"] / bounds.PEAK_BYTES_PER_S * 1e3)
  bwd = bounds.backward_bound(work, 10**6, 3, 3 * 10**6, 12288, (2048, 1536),
                              antialias=False, heuristic=True, visibility=True)
  assert bwd["ops"] > fwd["ops"] and bwd["bytes"] > fwd["bytes"]
