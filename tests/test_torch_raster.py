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
    "use_depth16"])
def test_formerly_unported_options_run(option):
  """The options that raised before the forward visibility and depth16
  keys were ported: each renders the image the plain render gives (atol
  1e-12), and the visibility options fill RasterOut.visibility, whose sum
  is the weight image's (the image is 16x16, so every pixel counts)."""
  points, depth, feats = scenes.points2d(5, 20, (16, 16))
  pts, d, f = (scenes.to_torch(x) for x in (points, depth, feats))
  config = RasterConfig(tile_size=8)
  plain = rasterize(pts, d, f, (16, 16), config)
  if option in ("compute_visibility", "compute_point_heuristic"):
    out = rasterize(pts, d, f, (16, 16), config.replace(**{option: True}))
  elif option == "heuristic_sink":
    out = rasterize(pts, d, f, (16, 16), config.replace(compute_point_heuristic=True),
                    heuristic_sink=torch.zeros(20, 2, dtype=torch.float64))
  else:
    out = rasterize(pts, d, f, (16, 16), config, use_depth16=True)
  torch.testing.assert_close(out.image, plain.image, rtol=0, atol=1e-12)
  assert out.bin_overflow is None and out.point_heuristic is None
  if option == "use_depth16":
    assert out.visibility is None
  else:
    assert not out.visibility.requires_grad and (out.visibility >= 0).all()
    torch.testing.assert_close(out.visibility.sum(), plain.image_weight.sum())


VIS_SIZE = (64, 48)     # a tile multiple: the JAX visibility counts the same pixels


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("blending", [True, False])
def test_forward_visibility_matches_jax(antialias, blending):
  """compute_visibility against the JAX package's forward visibility
  (float64, atol 1e-8; in quantile mode the counts of selecting pixels,
  exactly)."""
  s = SCENES["saturating"]
  points, depth, feats = scenes.points2d(s["seed"], N, VIS_SIZE, s["sigma_range"],
                                         s["alpha_range"])
  cfg = dict(antialias=antialias, use_alpha_blending=blending,
             compute_visibility=True)
  jcfg = JaxRasterConfig(tile_size=8, points_per_chunk=8, **cfg)
  jpts = jnp.asarray(points)
  jmap = jax_map_to_tiles(jpts, jnp.asarray(depth), VIS_SIZE, jcfg)
  want = jax_rasterize_with_tiles(jpts, jnp.asarray(feats), jmap, VIS_SIZE, jcfg)
  got = rasterize(scenes.to_torch(points), scenes.to_torch(depth),
                  scenes.to_torch(feats), VIS_SIZE, RasterConfig(tile_size=8, **cfg))
  assert got.visibility.shape == (N,)
  # quantile mode selects the point crossing 1e-4 of weight: the front ones
  assert (got.visibility > 0).sum() > (N // 2 if blending else 5)
  np.testing.assert_allclose(got.visibility.numpy(), np.asarray(want.visibility),
                             rtol=0, atol=1e-8)
  if not blending:
    np.testing.assert_array_equal(got.visibility.numpy(),
                                  np.round(got.visibility.numpy()))


@pytest.mark.parametrize("antialias", [False, True])
def test_forward_visibility_equals_the_sink(antialias):
  """On a frame with partial edge tiles: the forward's visibility equals
  the visibility sink's gradient (atol 1e-12) and adds up to the weight
  image (rtol 1e-12)."""
  points, depth, feats = scenes.points2d(7, N, SIZE)
  pts = scenes.to_torch(points).requires_grad_()
  vs = torch.zeros(N, dtype=torch.float64, requires_grad=True)
  config = RasterConfig(tile_size=8, antialias=antialias, compute_visibility=True)
  d, f = scenes.to_torch(depth), scenes.to_torch(feats)
  out = rasterize(pts, d, f, SIZE, config)
  rasterize(pts, d, f, SIZE, config, visibility_sink=vs).image.sum().backward()
  torch.testing.assert_close(out.visibility, vs.grad, rtol=0, atol=1e-12)
  torch.testing.assert_close(out.visibility.sum(), out.image_weight.sum(),
                             rtol=1e-12, atol=0)
  # the image stays differentiable beside the detached visibility
  out.image.sum().backward()
  assert torch.isfinite(pts.grad).all()


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
