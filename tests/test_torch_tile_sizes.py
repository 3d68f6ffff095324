"""The port at tile sizes that are not whole warps (4, 12) or larger than
one block of the kernels (40) against the JAX package, whose Pallas
kernels run in interpret mode on the CPU, as the JAX package's own tests
run them. On the CPU the port takes its plain versions; the card tests
(tests/test_torch_cuda.py) hold the kernels against those at tile sizes
1 to 64.

`rasterize` runs at tiles 4, 12 and 40 and `render_gaussians` at 12 and
40, forward and gradients, on the 62x45 frame (partial right and bottom
tiles at every size). Visibility and the sinks' gradients run
on a frame of whole tiles of the size at hand (64x48, 72x48, 80x40),
since the JAX kernel also counts a partial edge tile's pixels past the
image (ROADMAP queue 3, "divergences kept"). F is 3 (the F <= 4 register
instances on the card) or 34 (the wide instances); the JAX side stages 8
points per chunk.

Tolerances, those of the narrow tests:
* float64 forward (test_torch_raster): image and weight atol 1e-8.
* float64 visibility against the JAX visibility sink's gradient: atol 1e-8.
* float64 gradients wrt points, features and both sinks against jax.grad
  (test_torch_backward): rtol 1e-7, atol 1e-9.
* render_gaussians (test_torch_renderer): every image atol 1e-8; the
  gradients of the Gaussians3D tensors rtol 1e-6 and atol 1e-8 of each
  tensor's largest |gradient|, a culled point's NaN JAX gradient held to 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import taichi_gaussian_rasterizer_tpu as tgr_jax
from taichi_gaussian_rasterizer_tpu import RasterConfig as JaxRasterConfig
from taichi_gaussian_rasterizer_tpu.ops.mapper import map_to_tiles as jax_map_to_tiles
from taichi_gaussian_rasterizer_tpu.ops.raster import (
    rasterize_with_tiles as jax_rasterize_with_tiles)

from taichi_gaussian_rasterizer_tpu_torch import (RasterConfig, rasterize,
                                                  render_gaussians)
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import rasterize_with_tiles

import torch_port_scenes as scenes

SIZE = (62, 45)
WHOLE_TILES = {4: (64, 48), 12: (72, 48), 40: (80, 40)}
N = 300
# F = 3 on translucent splats, F = 34 on large opaque ones, where most
# pixels saturate and the gate and early exit decide the result
SCENES = {3: dict(seed=0, sigma_range=(0.8, 4.0), alpha_range=(0.1, 0.9)),
          34: dict(seed=1, sigma_range=(4.0, 10.0), alpha_range=(0.75, 0.99))}


def scene(n_features, size):
  s = SCENES[n_features]
  return scenes.points2d(s["seed"], N, size, s["sigma_range"], s["alpha_range"],
                         n_features=n_features)


def jax_mapping(points, depth, size, jcfg):
  """The JAX mapping with a static capacity that holds every overlap the
  port's exact mapper finds (the JAX default drops overlaps past its
  heuristic capacity at small tiles)."""
  total = int(map_to_tiles(scenes.to_torch(points), scenes.to_torch(depth), size,
                           RasterConfig(tile_size=jcfg.tile_size)).total_overlaps)
  mapping = jax_map_to_tiles(jnp.asarray(points), jnp.asarray(depth), size, jcfg,
                             capacity=total + 64)
  assert not bool(mapping.overflow)
  return mapping


def jax_config(tile_size, **cfg):
  return JaxRasterConfig(tile_size=tile_size, points_per_chunk=8,
                         exact_features=True, exact_slot_gradients=True,
                         deterministic=True, **cfg)


@pytest.mark.parametrize("tile_size,n_features,antialias,blending", [
    (4, 3, False, True), (4, 34, True, False), (12, 3, True, True),
    (12, 34, False, False), (40, 3, True, False), (40, 34, False, True)])
def test_tile_size_forward_float64_matches_jax(tile_size, n_features, antialias,
                                               blending):
  """`rasterize` at each tile size and width, each mode (blending or
  quantile, conic or antialiased pdf) at two of them."""
  points, depth, feats = scene(n_features, SIZE)
  cfg = dict(antialias=antialias, use_alpha_blending=blending)
  jcfg = jax_config(tile_size, **cfg)
  jpts = jnp.asarray(points)
  jmap = jax_mapping(points, depth, SIZE, jcfg)
  want = jax.jit(lambda p, f: jax_rasterize_with_tiles(p, f, jmap, SIZE, jcfg))(
      jpts, jnp.asarray(feats))
  got = rasterize(scenes.to_torch(points), scenes.to_torch(depth),
                  scenes.to_torch(feats), SIZE,
                  RasterConfig(tile_size=tile_size, **cfg))
  assert got.image.shape == (SIZE[1], SIZE[0], n_features)
  for name in ("image", "image_weight"):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)), atol=1e-8,
                               rtol=0, err_msg=name)
  assert got.image_weight.numpy().max() > 0.5


@pytest.mark.parametrize("tile_size,n_features,antialias", [
    (4, 3, True), (4, 34, False), (12, 3, False), (12, 34, True),
    (40, 3, False), (40, 34, True)])
def test_tile_size_visibility_and_grads_float64_match_jax(tile_size, n_features,
                                                          antialias):
  """With compute_visibility and compute_point_heuristic on a frame of
  whole tiles: the gradients wrt points and features and the heuristic and
  visibility sinks of sum(image * G1) + sum(weight * G2), G seeded normal,
  against jax.grad, and the forward's per-point visibility against the
  JAX visibility sink's gradient (the same sums of blend weights)."""
  size = WHOLE_TILES[tile_size]
  points, depth, feats = scene(n_features, size)
  rng = np.random.default_rng(100 + tile_size + n_features)
  g1 = rng.normal(size=(size[1], size[0], n_features))
  g2 = rng.normal(size=(size[1], size[0]))
  cfg = dict(antialias=antialias, compute_point_heuristic=True,
             compute_visibility=True)
  jcfg = jax_config(tile_size, **cfg)
  jpts = jnp.asarray(points)
  jmap = jax_mapping(points, depth, size, jcfg)

  def jax_loss(p, f, hs, vs):
    out = jax_rasterize_with_tiles(p, f, jmap, size, jcfg,
                                   heuristic_sink=hs, visibility_sink=vs)
    return jnp.sum(out.image * g1) + jnp.sum(out.image_weight * g2)

  want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(
      jpts, jnp.asarray(feats), jnp.zeros((N, 2)), jnp.zeros((N,)))

  leaves = [scenes.to_torch(points).requires_grad_(),
            scenes.to_torch(feats).requires_grad_(),
            torch.zeros(N, 2, dtype=torch.float64, requires_grad=True),
            torch.zeros(N, dtype=torch.float64, requires_grad=True)]
  config = RasterConfig(tile_size=tile_size, **cfg)
  mapping = map_to_tiles(leaves[0].detach(), scenes.to_torch(depth), size, config)
  with torch.no_grad():
    vis = rasterize_with_tiles(leaves[0], leaves[1], mapping, size,
                               config).visibility
  assert (vis > 0).sum() > N // 4
  # the per-point visibility is the visibility sink's gradient
  np.testing.assert_allclose(vis.numpy(), np.asarray(want[3]), rtol=0,
                             atol=1e-8, err_msg="visibility")
  out = rasterize_with_tiles(leaves[0], leaves[1], mapping, size, config,
                             heuristic_sink=leaves[2], visibility_sink=leaves[3])
  loss = ((out.image * scenes.to_torch(g1)).sum()
          + (out.image_weight * scenes.to_torch(g2)).sum())
  got = torch.autograd.grad(loss, leaves)
  for name, g, w in zip(("points", "features", "heuristic", "visibility"),
                        got, want):
    assert np.abs(np.asarray(w)).max() > 0, name
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7, atol=1e-9,
                               err_msg=name)


GAUSSIAN_FIELDS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


@pytest.mark.parametrize("tile_size,raw_channels", [(12, 1), (40, 32)])
def test_render_gaussians_at_tile_sizes_matches_jax(tile_size, raw_channels):
  """render_gaussians(use_sh=False, render_depth=True) on the 62x45 frame:
  raw_channels + 2 blended channels (F = 3 or 34). The image, weight, depth
  and depth variance, and the gradients of sum(image * G1) + sum(weight *
  G2) + sum(depth * G3) wrt every Gaussians3D tensor."""
  cam = scenes.camera(20 + tile_size, SIZE)
  g = scenes.gaussians3d(21 + tile_size, N, cam)
  g["feature"] = np.random.default_rng(22).normal(size=(N, raw_channels))
  rng = np.random.default_rng(23)
  terms = (rng.normal(size=(SIZE[1], SIZE[0], raw_channels)),
           rng.normal(size=(SIZE[1], SIZE[0])), rng.normal(size=(SIZE[1], SIZE[0])))
  jg, jcam = scenes.jax_scene(cam, g, np.float64)
  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  kw = dict(use_sh=False, render_depth=True)

  def jax_loss(x):
    r = tgr_jax.render_gaussians(
        x, jcam, tgr_jax.RasterConfig(tile_size=tile_size, points_per_chunk=8),
        **kw)
    loss = (jnp.sum(r.image * terms[0]) + jnp.sum(r.image_weight * terms[1])
            + jnp.sum(r.depth * terms[2]))
    return loss, r

  (_, want), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jg)
  leaves = tg.replace(**{name: getattr(tg, name).requires_grad_()
                         for name in GAUSSIAN_FIELDS})
  got = render_gaussians(leaves, tcam, RasterConfig(tile_size=tile_size), **kw)
  assert got.image.shape == (SIZE[1], SIZE[0], raw_channels)
  for name in ("image", "image_weight", "depth", "depth_var"):
    np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                               np.asarray(getattr(want, name)), atol=1e-8,
                               rtol=0, err_msg=name)
  t = [torch.as_tensor(x) for x in terms]
  ((got.image * t[0]).sum() + (got.image_weight * t[1]).sum()
   + (got.depth * t[2]).sum()).backward()
  for name in GAUSSIAN_FIELDS:
    grad, ref = getattr(leaves, name).grad.numpy(), np.asarray(getattr(want_grads, name))
    assert np.isfinite(grad).all(), name
    culled = ~np.isfinite(ref).reshape(ref.shape[0], -1).all(1)
    assert (grad[culled] == 0).all(), name
    grad, ref = grad[~culled], ref[~culled]
    scale = np.abs(ref).max()
    assert scale > 0, name
    np.testing.assert_allclose(grad, ref, rtol=1e-6, atol=1e-8 * scale,
                               err_msg=name)
