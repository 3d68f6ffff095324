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
