"""The port's rasterizer against the JAX package's Pallas forward kernel
(run in interpret mode on the CPU, as the JAX package's own tests run it).

The image is 62x45 with 8x8 tiles, so the right and bottom tiles are
partial; the JAX side stages 8 points per chunk, so bins span many chunks.

Tolerances:
* float64: image and weight atol 1e-8. The two sides differ only in how
  log(alpha) is expanded (a monomial matmul on the TPU side) and in the
  transmittance product (exp of a cumulative log sum there).
* float32 (JAX with exact_features and deterministic): p99.9 |diff|
  <= 1e-3 and max |diff| <= 2e-2, because an alpha or saturation gate can
  flip on a borderline pixel between the two float32 evaluations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import RasterConfig as JaxRasterConfig
from taichi_gaussian_rasterizer_tpu.ops.mapper import map_to_tiles as jax_map_to_tiles
from taichi_gaussian_rasterizer_tpu.ops.raster import (
    rasterize_with_tiles as jax_rasterize_with_tiles)

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
    rasterize, rasterize_tiles_plain, rasterize_with_tiles, tiles)
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import function as raster_function

import torch_port_scenes as scenes

SIZE = (62, 45)
N = 300
SCENES = {
    "translucent": dict(seed=0, sigma_range=(0.8, 4.0), alpha_range=(0.1, 0.9)),
    # large opaque splats: most pixels saturate, so the saturation gate
    # (and the kernels' early exit) decide the result
    "saturating": dict(seed=1, sigma_range=(4.0, 10.0), alpha_range=(0.75, 0.99)),
}


def render_both(scene, dtype, **cfg):
  s = SCENES[scene]
  points, depth, feats = scenes.points2d(s["seed"], N, SIZE, s["sigma_range"],
                                         s["alpha_range"])
  jcfg = JaxRasterConfig(tile_size=8, points_per_chunk=8, exact_features=True,
                         deterministic=True, **cfg)
  jpts = jnp.asarray(points, dtype)
  jmap = jax_map_to_tiles(jpts, jnp.asarray(depth, dtype), SIZE, jcfg)
  want = jax_rasterize_with_tiles(jpts, jnp.asarray(feats, dtype), jmap, SIZE, jcfg)
  got = rasterize(scenes.to_torch(points, dtype), scenes.to_torch(depth, dtype),
                  scenes.to_torch(feats, dtype), SIZE,
                  RasterConfig(tile_size=8, **cfg))
  return got, want


@pytest.mark.parametrize("scene", ["translucent", "saturating"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("blending", [True, False])
def test_raster_float64_matches_jax(scene, antialias, blending):
  got, want = render_both(scene, np.float64, antialias=antialias,
                          use_alpha_blending=blending)
  assert got.image.shape == (SIZE[1], SIZE[0], 3)
  np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                             atol=1e-8, rtol=0)
  np.testing.assert_allclose(got.image_weight.numpy(),
                             np.asarray(want.image_weight), atol=1e-8, rtol=0)
  saturated = (got.image_weight.numpy() >= 0.9999).mean()
  if blending and scene == "saturating":
    assert saturated > 0.5
  elif blending:
    assert saturated < 0.5


def assert_float32_close(got, want):
  diff = np.abs(scenes.to_numpy(got) - np.asarray(want)).ravel()
  assert np.quantile(diff, 0.999) <= 1e-3, np.quantile(diff, 0.999)
  assert diff.max() <= 2e-2, diff.max()


@pytest.mark.parametrize("scene,antialias,blending", [
    ("translucent", False, True),
    ("saturating", True, True),
    ("saturating", False, False),
])
def test_raster_float32_matches_jax(scene, antialias, blending):
  got, want = render_both(scene, np.float32, antialias=antialias,
                          use_alpha_blending=blending)
  assert got.image.dtype == torch.float32
  assert_float32_close(got.image, want.image)
  assert_float32_close(got.image_weight, want.image_weight)


def test_plain_on_tile_subset():
  """The plain version on a subset of tiles gives those tiles of the full
  frame, in the order asked for (pixels past the image edge, which the
  full frame crops, are left out of the comparison). float64, atol 1e-12:
  a subset pads its bins to another length, which reorders the sums."""
  points, depth, feats = scenes.points2d(3, N, SIZE)
  config = RasterConfig(tile_size=8)
  pts, f = scenes.to_torch(points), scenes.to_torch(feats)
  mapping = map_to_tiles(pts, scenes.to_torch(depth), SIZE, config)
  full = rasterize_with_tiles(pts, f, mapping, SIZE, config)
  ids = [39, 0, 17, 47, 5]          # 39 and 47 are partial edge tiles
  image, weight = rasterize_tiles_plain(pts, f, mapping, config, tile_ids=ids)
  full_tiles = tiles.image_to_tiles(
      torch.cat([full.image, full.image_weight[..., None]], dim=-1),
      mapping.tile_shape, 8)[ids]
  inside = tiles.image_to_tiles(torch.ones(SIZE[1], SIZE[0], 1),
                                mapping.tile_shape, 8)[ids, 0] > 0
  assert not inside.all()
  torch.testing.assert_close(image * inside[:, None], full_tiles[:, :3],
                             rtol=0, atol=1e-12)
  torch.testing.assert_close(weight * inside, full_tiles[:, 3], rtol=0, atol=1e-12)


def test_cpu_autograd_reaches_points_and_features():
  points, depth, feats = scenes.points2d(4, 60, (32, 24))
  pts = scenes.to_torch(points).requires_grad_()
  f = scenes.to_torch(feats).requires_grad_()
  out = rasterize(pts, scenes.to_torch(depth), f, (32, 24), RasterConfig(tile_size=8))
  (out.image.sum() + out.image_weight.sum()).backward()
  assert torch.isfinite(pts.grad).all() and pts.grad.abs().sum() > 0
  # d(sum image)/d(features)[:, c] is each point's total blend weight
  assert (f.grad >= 0).all() and f.grad.sum() > 0
  torch.testing.assert_close(f.grad, f.grad[:, :1].expand(-1, 3))


@pytest.mark.parametrize("option", [
    "compute_visibility", "compute_point_heuristic", "heuristic_sink",
    "use_depth16", "truncate_mapping", "probe_visit_chunks"])
def test_unported_options_raise(option):
  """The forward's per-point visibility is not ported: compute_visibility,
  and compute_point_heuristic without a visibility sink (with or without
  a heuristic sink), raise, as do depth16 keys and truncation."""
  points, depth, feats = scenes.points2d(5, 20, (16, 16))
  pts, d, f = (scenes.to_torch(x) for x in (points, depth, feats))
  config = RasterConfig(tile_size=8)
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    if option in ("compute_visibility", "compute_point_heuristic"):
      rasterize(pts, d, f, (16, 16), config.replace(**{option: True}))
    elif option == "heuristic_sink":
      rasterize(pts, d, f, (16, 16), config.replace(compute_point_heuristic=True),
                heuristic_sink=torch.zeros(20, 2, dtype=torch.float64))
    elif option == "use_depth16":
      rasterize(pts, d, f, (16, 16), config, use_depth16=True)
    else:
      getattr(raster_function, option)()


@pytest.mark.parametrize("heuristic", [False, True])
def test_sinks_take_training_outputs(heuristic):
  """With a visibility sink, the sinks' gradients are the training-mode
  outputs: visibility always, heuristics with compute_point_heuristic
  (no gradient without it)."""
  points, depth, feats = scenes.points2d(6, 60, (32, 24))
  pts = scenes.to_torch(points).requires_grad_()
  hs = torch.zeros(60, 2, dtype=torch.float64, requires_grad=True)
  vs = torch.zeros(60, dtype=torch.float64, requires_grad=True)
  config = RasterConfig(tile_size=8, compute_point_heuristic=heuristic)
  out = rasterize(pts, scenes.to_torch(depth), scenes.to_torch(feats), (32, 24),
                  config, heuristic_sink=hs, visibility_sink=vs)
  assert out.point_heuristic is None and out.visibility is None
  (out.image ** 2).sum().backward()
  assert (vs.grad >= 0).all() and vs.grad.sum() > 0
  if heuristic:
    assert (hs.grad >= 0).all() and hs.grad.sum() > 0
  else:
    assert hs.grad is None
