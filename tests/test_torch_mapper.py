"""The port's tile mapper against the JAX mapper.

Exact comparison: every tile's ordered point list, the overlap total,
the overflow flag and the per-point segment offsets must equal the JAX
mapper's. N <= 4096 makes the JAX
mapper emit every candidate, depths are distinct (ties may order
differently), and the JAX capacity is large enough that only the
`max_tile_span` clamp can set `overflow`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import RasterConfig as JaxRasterConfig
from taichi_gaussian_rasterizer_tpu.ops.mapper import map_to_tiles as jax_map_to_tiles

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles

import torch_port_scenes as scenes


CASES = [
    (np.float64, (64, 48), 8, 300, (0.8, 4.0), 16),   # bins of tens of points
    (np.float32, (64, 48), 8, 300, (0.8, 4.0), 16),
    (np.float64, (62, 45), 16, 400, (0.8, 6.0), 16),  # partial edge tiles
    (np.float64, (64, 48), 8, 200, (2.0, 9.0), 3),    # clamped footprints
]


def map_both(dtype, image_size, tile_size, n, sigma_range, max_span):
  points, depth, _ = scenes.points2d(tile_size + n, n, image_size, sigma_range)
  kw = dict(tile_size=tile_size, max_tile_span=max_span, deterministic=True)
  want = jax_map_to_tiles(jnp.asarray(points, dtype), jnp.asarray(depth, dtype),
                          image_size, JaxRasterConfig(points_per_chunk=8, **kw),
                          capacity=64 * n)
  got = map_to_tiles(scenes.to_torch(points, dtype), scenes.to_torch(depth, dtype),
                     image_size, RasterConfig(**kw))
  return got, want


def tile_lists(otp, ranges):
  otp, ranges = scenes.to_numpy(otp), scenes.to_numpy(ranges)
  return [otp[s:e].tolist() for s, e in ranges]


@pytest.mark.parametrize("dtype,image_size,tile_size,n,sigma_range,max_span", CASES)
def test_mapper_matches_jax(dtype, image_size, tile_size, n, sigma_range, max_span):
  got, want = map_both(dtype, image_size, tile_size, n, sigma_range, max_span)

  assert got.tile_shape == want.tile_shape
  total = int(got.total_overlaps)
  assert total == int(want.total_overlaps) > 0
  assert bool(got.overflow) == bool(want.overflow) == (max_span < 16)
  assert tile_lists(got.overlap_to_point, got.tile_ranges) == \
      tile_lists(want.overlap_to_point, want.tile_ranges)
  # bins abut from 0; the rejected candidates trail them as sentinels
  ranges = scenes.to_numpy(got.tile_ranges)
  assert ranges[0, 0] == 0 and ranges[-1, 1] == total
  np.testing.assert_array_equal(ranges[1:, 0], ranges[:-1, 1])
  assert (scenes.to_numpy(got.overlap_to_point)[total:] == n).all()
  np.testing.assert_array_equal(
      scenes.to_numpy(got.overlap_to_tile)[:total],
      np.repeat(np.arange(len(ranges)), ranges[:, 1] - ranges[:, 0]))


@pytest.mark.parametrize("dtype,image_size,tile_size,n,sigma_range,max_span", CASES)
def test_point_offsets_match_jax(dtype, image_size, tile_size, n, sigma_range,
                                 max_span):
  """point_offsets (N+1,): each point's segment in point-sorted slot order,
  exactly the JAX mapper's; its last entry is the overlap total."""
  got, want = map_both(dtype, image_size, tile_size, n, sigma_range, max_span)
  offsets = scenes.to_numpy(got.point_offsets)
  assert got.point_offsets.dtype == torch.int32 and offsets.shape == (n + 1,)
  np.testing.assert_array_equal(offsets, np.asarray(want.point_offsets))
  assert offsets[-1] == int(got.total_overlaps)
  otp = scenes.to_numpy(got.overlap_to_point)
  np.testing.assert_array_equal(np.diff(offsets), np.bincount(otp, minlength=n + 1)[:n])


def tile_d16(mapping, depth):
  """Each tile's sequence of 16-bit quantized depths, in bin order."""
  d16 = np.floor(np.clip(scenes.to_numpy(depth), 0, 1) * 65535).astype(np.int64)
  return [d16[pts].tolist() for pts in tile_lists(mapping.overlap_to_point,
                                                  mapping.tile_ranges)]


def depth16_scene(dtype, image_size, tile_size, n, sigma_range):
  """Depths near a coarse grid, so that many quantized depths tie (and
  those past 1 quantize to 65535), yet all distinct, so that the full
  depth orders every tie."""
  points, depth, _ = scenes.points2d(tile_size + n + 1, n, image_size, sigma_range)
  depth = np.round(depth * 40) / 40 + np.random.default_rng(n).permutation(n) * 5e-7
  assert len(np.unique(depth.astype(dtype))) == n
  return points.astype(dtype), depth.astype(dtype)


@pytest.mark.parametrize("dtype,image_size,tile_size,n,sigma_range,max_span", CASES)
def test_depth16_deterministic_matches_jax(dtype, image_size, tile_size, n,
                                           sigma_range, max_span):
  """use_depth16 with deterministic: every tile's list equals the JAX
  mapper's (quantized ties broken on the full depth in both)."""
  points, depth = depth16_scene(dtype, image_size, tile_size, n, sigma_range)
  kw = dict(tile_size=tile_size, max_tile_span=max_span, deterministic=True)
  want = jax_map_to_tiles(jnp.asarray(points), jnp.asarray(depth), image_size,
                          JaxRasterConfig(points_per_chunk=8, **kw),
                          capacity=64 * n, use_depth16=True)
  got = map_to_tiles(scenes.to_torch(points), scenes.to_torch(depth), image_size,
                     RasterConfig(**kw), use_depth16=True)
  assert int(got.total_overlaps) == int(want.total_overlaps) > 0
  assert bool(got.overflow) == bool(want.overflow)
  assert tile_lists(got.overlap_to_point, got.tile_ranges) == \
      tile_lists(want.overlap_to_point, want.tile_ranges)
  np.testing.assert_array_equal(scenes.to_numpy(got.point_offsets),
                                np.asarray(want.point_offsets))


@pytest.mark.parametrize("dtype,image_size,tile_size,n,sigma_range,max_span",
                         CASES[:3])
def test_depth16_sorts_quantized_depths(dtype, image_size, tile_size, n,
                                        sigma_range, max_span):
  """use_depth16 without deterministic: every tile's quantized depths are
  non-decreasing, its point set is the full-depth mapping's, and ties keep
  point order (the sort is stable)."""
  points, depth = depth16_scene(dtype, image_size, tile_size, n, sigma_range)
  kw = dict(tile_size=tile_size, max_tile_span=max_span)
  pts, d = scenes.to_torch(points), scenes.to_torch(depth)
  got = map_to_tiles(pts, d, image_size, RasterConfig(**kw), use_depth16=True)
  full = map_to_tiles(pts, d, image_size, RasterConfig(**kw))
  assert int(got.total_overlaps) == int(full.total_overlaps)
  lists = tile_lists(got.overlap_to_point, got.tile_ranges)
  assert [sorted(x) for x in lists] == \
      [sorted(x) for x in tile_lists(full.overlap_to_point, full.tile_ranges)]
  ties = 0
  for seq, ids in zip(tile_d16(got, d), lists):
    assert seq == sorted(seq)
    for a, b, i, j in zip(seq, seq[1:], ids, ids[1:]):
      if a == b:
        ties += 1
        assert i < j
  assert ties > 0
  np.testing.assert_array_equal(scenes.to_numpy(got.point_offsets),
                                scenes.to_numpy(full.point_offsets))


def test_depth16_rejects_a_grid_that_reaches_the_sentinel():
  points, depth, _ = scenes.points2d(0, 10, (64, 48))
  with pytest.raises(ValueError, match="0xFFFF"):
    map_to_tiles(scenes.to_torch(points), scenes.to_torch(depth), (4096, 4096),
                 RasterConfig(tile_size=16), use_depth16=True)
  # one tile fewer than the sentinel is fine
  map_to_tiles(scenes.to_torch(points), scenes.to_torch(depth), (0xFFFE, 1),
               RasterConfig(tile_size=1), use_depth16=True)
