"""The port at feature widths past 16 channels against the JAX package,
whose Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them. On the CPU the port takes its plain
versions; the card tests (tests/test_torch_cuda.py) hold the wide kernels
against those.

The image is 62x45 with 8x8 tiles (partial right and bottom tiles), or
64x48 where visibility is compared, so that both packages count the same
pixels; the JAX side stages 8 points per chunk. F is 17 (one channel past
the register instances) or 40.

Tolerances, those of the narrow tests:
* float64 forward (test_torch_raster): image and weight atol 1e-8.
* float32 forward (JAX with exact_features and deterministic): p99.9
  |diff| <= 1e-3 and max |diff| <= 2e-2, since an alpha or saturation
  gate can flip on a borderline pixel between the two evaluations.
* float64 visibility: atol 1e-8.
* float64 gradients wrt points, features and both sinks against jax.grad
  (test_torch_backward): rtol 1e-7, atol 1e-9.

Nine cases in all, each JAX function compiled once (jit), so that the file
stays under a minute on one worker.
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
VIS_SIZE = (64, 48)
N = 300
# F = 17 on translucent splats, F = 40 on large opaque ones, where most
# pixels saturate and the gate and early exit decide the result
SCENES = {17: dict(seed=0, sigma_range=(0.8, 4.0), alpha_range=(0.1, 0.9)),
          40: dict(seed=1, sigma_range=(4.0, 10.0), alpha_range=(0.75, 0.99))}


def scene(n_features, size=SIZE):
  s = SCENES[n_features]
  return scenes.points2d(s["seed"], N, size, s["sigma_range"], s["alpha_range"],
                         n_features=n_features)


def render_both(n_features, dtype, size=SIZE, **cfg):
  points, depth, feats = scene(n_features, size)
  jcfg = JaxRasterConfig(tile_size=8, points_per_chunk=8, exact_features=True,
                         deterministic=True, **cfg)
  jpts = jnp.asarray(points, dtype)
  jmap = jax_map_to_tiles(jpts, jnp.asarray(depth, dtype), size, jcfg)
  want = jax_rasterize_with_tiles(jpts, jnp.asarray(feats, dtype), jmap, size, jcfg)
  got = rasterize(scenes.to_torch(points, dtype), scenes.to_torch(depth, dtype),
                  scenes.to_torch(feats, dtype), size,
                  RasterConfig(tile_size=8, **cfg))
  assert got.image.shape == (size[1], size[0], n_features)
  return got, want


@pytest.mark.parametrize("n_features,antialias,blending", [
    (17, False, True), (17, True, False), (40, True, True), (40, False, False)])
def test_wide_forward_float64_matches_jax(n_features, antialias, blending):
  """Each mode (blending or quantile, conic or antialiased pdf) at one of
  the two widths."""
  got, want = render_both(n_features, np.float64, antialias=antialias,
                          use_alpha_blending=blending)
  for name in ("image", "image_weight"):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)), atol=1e-8,
                               rtol=0, err_msg=name)
  saturated = (got.image_weight.numpy() >= 0.9999).mean()
  if blending:
    assert (saturated > 0.5) == (n_features == 40), saturated


def test_wide_forward_float32_matches_jax():
  """F = 40, antialiased, blending: two channel groups of the kernels."""
  got, want = render_both(40, np.float32, antialias=True)
  assert got.image.dtype == torch.float32
  for name in ("image", "image_weight"):
    diff = np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name)))
    assert np.quantile(diff, 0.999) <= 1e-3, (name, np.quantile(diff, 0.999))
    assert diff.max() <= 2e-2, (name, diff.max())


def test_wide_forward_visibility_matches_jax():
  """F = 40, antialiased, on the 64x48 frame: the per-point visibility."""
  got, want = render_both(40, np.float64, size=VIS_SIZE, antialias=True,
                          compute_visibility=True)
  assert got.visibility.shape == (N,) and (got.visibility > 0).sum() > N // 2
  np.testing.assert_allclose(got.visibility.numpy(), np.asarray(want.visibility),
                             rtol=0, atol=1e-8)


@pytest.mark.parametrize("n_features,antialias", [(17, True), (40, False)])
def test_wide_grads_float64_match_jax(n_features, antialias):
  """Gradients wrt points and features and the heuristic and visibility
  sinks of sum(image * G1) + sum(weight * G2), G seeded normal, against
  jax.grad, with compute_point_heuristic, on the 64x48 frame."""
  points, depth, feats = scene(n_features, VIS_SIZE)
  rng = np.random.default_rng(100 + n_features)
  g1 = rng.normal(size=(VIS_SIZE[1], VIS_SIZE[0], n_features))
  g2 = rng.normal(size=(VIS_SIZE[1], VIS_SIZE[0]))
  cfg = dict(antialias=antialias, compute_point_heuristic=True)
  jcfg = JaxRasterConfig(tile_size=8, points_per_chunk=8, exact_features=True,
                         exact_slot_gradients=True, deterministic=True, **cfg)
  jpts = jnp.asarray(points)
  jmap = jax_map_to_tiles(jpts, jnp.asarray(depth), VIS_SIZE, jcfg)

  def jax_loss(p, f, hs, vs):
    out = jax_rasterize_with_tiles(p, f, jmap, VIS_SIZE, jcfg,
                                   heuristic_sink=hs, visibility_sink=vs)
    return jnp.sum(out.image * g1) + jnp.sum(out.image_weight * g2)

  want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(
      jpts, jnp.asarray(feats), jnp.zeros((N, 2)), jnp.zeros((N,)))

  leaves = [scenes.to_torch(points).requires_grad_(),
            scenes.to_torch(feats).requires_grad_(),
            torch.zeros(N, 2, dtype=torch.float64, requires_grad=True),
            torch.zeros(N, dtype=torch.float64, requires_grad=True)]
  config = RasterConfig(tile_size=8, **cfg)
  mapping = map_to_tiles(leaves[0].detach(), scenes.to_torch(depth), VIS_SIZE,
                         config)
  out = rasterize_with_tiles(leaves[0], leaves[1], mapping, VIS_SIZE, config,
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


def test_render_gaussians_wide_raw_features_match_jax():
  """A feature-field frame: 30 raw channels with use_sh=False and
  render_depth (32 blended). The image, weight, depth and depth variance,
  and the gradients of sum(image * G1) + sum(weight * G2) + sum(depth *
  G3) wrt every Gaussians3D tensor."""
  size = (64, 48)
  cam = scenes.camera(20, size)
  g = scenes.gaussians3d(21, N, cam)
  g["feature"] = np.random.default_rng(22).normal(size=(N, 30))
  rng = np.random.default_rng(23)
  terms = (rng.normal(size=(size[1], size[0], 30)),
           rng.normal(size=(size[1], size[0])), rng.normal(size=(size[1], size[0])))
  jg, jcam = scenes.jax_scene(cam, g, np.float64)
  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  kw = dict(use_sh=False, render_depth=True)

  def jax_loss(x):
    r = tgr_jax.render_gaussians(
        x, jcam, tgr_jax.RasterConfig(tile_size=8, points_per_chunk=8), **kw)
    loss = (jnp.sum(r.image * terms[0]) + jnp.sum(r.image_weight * terms[1])
            + jnp.sum(r.depth * terms[2]))
    return loss, r

  (_, want), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jg)
  leaves = tg.replace(**{name: getattr(tg, name).requires_grad_()
                         for name in GAUSSIAN_FIELDS})
  got = render_gaussians(leaves, tcam, RasterConfig(tile_size=8), **kw)
  assert got.image.shape == (size[1], size[0], 30)
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
