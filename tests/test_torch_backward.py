"""The port's training-frame raster backward against the JAX package's
custom VJP (its Pallas backward and segment-sum kernels, run in interpret
mode on the CPU, as the JAX package's own tests run them), against
autograd straight through the port's plain forward, and the build key of
the CUDA sources.

The image is 64x48 with 8x8 tiles (no partial tiles, so the visibility
rows of the two packages count the same pixels); the JAX side stages 8
points per chunk, so bins span many chunks. The loss is
sum(image * G1) + sum(weight * G2) with seeded normal G, so the weight
image's cotangent is exercised.

Tolerances:
* float64 against jax.grad: rtol 1e-7, atol 1e-9 (points, features and
  both sinks). The JAX kernel sums the conic rows as raw pixel moments
  and the transmittance as exp of a cumulative log sum; the port sums
  per pixel directly.
* float64 against autograd through the plain forward: rtol 1e-9, atol
  1e-12 (the same arithmetic, summed in another order).
* float32 against JAX (exact_slot_gradients, exact_features,
  deterministic): relative L2 <= 2e-3 and max |diff| <= 5e-3 of the
  largest |gradient|, per argument. That is the JAX package's own float32
  error (its test_f32_exact_transport_close_to_truth bound, 5e-3): its
  kernels take the transmittance and C cumsums as one-pass bf16 matmuls.
  The port's float32 gradient is also held to its own float64 gradient:
  relative L2 <= 1e-5 and max |diff| <= 1e-5 of the largest |gradient|.
"""

import jax
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
    backward, forward, rasterize, rasterize_with_tiles, tiles)
from taichi_gaussian_rasterizer_tpu_torch.utils import cuda_build

import torch_port_scenes as scenes

SIZE = (64, 48)
N = 300
SCENES = {
    "translucent": dict(seed=0, sigma_range=(0.8, 4.0), alpha_range=(0.1, 0.9)),
    # large opaque splats: most pixels saturate, so the replay stops early
    # and the saturation gate decides which slots get gradients
    "saturating": dict(seed=1, sigma_range=(4.0, 10.0), alpha_range=(0.75, 0.99)),
}


def cotangents(seed, n_features=3):
  rng = np.random.default_rng(seed + 100)
  return (rng.normal(size=(SIZE[1], SIZE[0], n_features)),
          rng.normal(size=(SIZE[1], SIZE[0])))


def grads_both(scene, dtype, sinks=False, **cfg):
  """Gradients of the loss wrt points and features [and the two sinks]
  from the JAX package and from the port, as numpy."""
  s = SCENES[scene]
  points, depth, feats = scenes.points2d(s["seed"], N, SIZE, s["sigma_range"],
                                         s["alpha_range"])
  g1, g2 = cotangents(s["seed"])
  jcfg = JaxRasterConfig(tile_size=8, points_per_chunk=8, exact_features=True,
                         exact_slot_gradients=True, deterministic=True, **cfg)
  jpts = jnp.asarray(points, dtype)
  jmap = jax_map_to_tiles(jpts, jnp.asarray(depth, dtype), SIZE, jcfg)

  def jax_loss(p, f, hs, vs):
    kw = dict(heuristic_sink=hs, visibility_sink=vs) if sinks else {}
    out = jax_rasterize_with_tiles(p, f, jmap, SIZE, jcfg, **kw)
    return (jnp.sum(out.image * jnp.asarray(g1, dtype))
            + jnp.sum(out.image_weight * jnp.asarray(g2, dtype)))

  want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
      jpts, jnp.asarray(feats, dtype), jnp.zeros((N, 2), dtype),
      jnp.zeros((N,), dtype))

  pts = scenes.to_torch(points, dtype).requires_grad_()
  f = scenes.to_torch(feats, dtype).requires_grad_()
  hs = torch.zeros(N, 2, dtype=pts.dtype, requires_grad=True)
  vs = torch.zeros(N, dtype=pts.dtype, requires_grad=True)
  config = RasterConfig(tile_size=8, **cfg)
  mapping = map_to_tiles(pts.detach(), scenes.to_torch(depth, dtype), SIZE, config)
  kw = dict(heuristic_sink=hs, visibility_sink=vs) if sinks else {}
  out = rasterize_with_tiles(pts, f, mapping, SIZE, config, **kw)
  loss = ((out.image * scenes.to_torch(g1, dtype)).sum()
          + (out.image_weight * scenes.to_torch(g2, dtype)).sum())
  got = torch.autograd.grad(loss, [pts, f, hs, vs] if sinks else [pts, f])
  return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("scene", ["translucent", "saturating"])
@pytest.mark.parametrize("antialias", [False, True])
def test_grads_float64_match_jax(scene, antialias):
  (gp, gf), (wp, wf, _, _) = grads_both(scene, np.float64, antialias=antialias)
  assert np.abs(wp).max() > 0 and np.abs(wf).max() > 0
  np.testing.assert_allclose(gp, wp, rtol=1e-7, atol=1e-9)
  np.testing.assert_allclose(gf, wf, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("antialias", [False, True])
def test_sinks_float64_match_jax(antialias):
  """Heuristics (prune cost, split score) and visibility as the sinks'
  gradients, with config.compute_point_heuristic."""
  got, want = grads_both("translucent", np.float64, sinks=True,
                         antialias=antialias, compute_point_heuristic=True)
  for name, g, w in zip(("points", "features", "heuristic", "visibility"),
                        got, want):
    assert np.abs(w).max() > 0, name
    np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-9, err_msg=name)
  assert (got[2] >= 0).all() and (got[3] >= 0).all()


def test_grads_float32_match_jax():
  got, want = grads_both("translucent", np.float32)
  truth, _ = grads_both("translucent", np.float64)
  for g, w, t in zip(got, want, truth):
    assert g.dtype == np.float32
    assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w)
    assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max()
    assert np.linalg.norm(g - t) <= 1e-5 * np.linalg.norm(t)
    assert np.abs(g - t).max() <= 1e-5 * np.abs(t).max()


@pytest.mark.parametrize("scene", ["translucent", "saturating"])
@pytest.mark.parametrize("antialias", [False, True])
def test_grads_match_autograd_through_plain_forward(scene, antialias):
  """A JAX-free oracle: the autograd Function's gradient (plain backward,
  plain reduction, the conic chain) equals torch.autograd differentiating
  rasterize_tiles_plain itself."""
  s = SCENES[scene]
  points, depth, feats = scenes.points2d(s["seed"] + 10, N, SIZE,
                                         s["sigma_range"], s["alpha_range"])
  g1, g2 = (scenes.to_torch(g) for g in cotangents(s["seed"] + 10))
  config = RasterConfig(tile_size=8, antialias=antialias)
  pts, f = scenes.to_torch(points), scenes.to_torch(feats)
  mapping = map_to_tiles(pts, scenes.to_torch(depth), SIZE, config)

  def grads(render):
    p, ff = pts.clone().requires_grad_(), f.clone().requires_grad_()
    image, weight = render(p, ff)
    return torch.autograd.grad((image * g1).sum() + (weight * g2).sum(), [p, ff])

  def function(p, ff):
    out = rasterize_with_tiles(p, ff, mapping, SIZE, config)
    return out.image, out.image_weight

  def plain(p, ff):
    image, weight = forward.rasterize_tiles_plain(p, ff, mapping, config)
    return (tiles.tiles_to_image(image, mapping.tile_shape, 8, SIZE),
            tiles.tiles_to_image(weight[:, None], mapping.tile_shape, 8, SIZE)[..., 0])

  for got, want in zip(grads(function), grads(plain)):
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


def test_visibility_identity():
  """d(sum image)/d(features)[:, c] equals each point's visibility, the
  visibility sink's gradient (SURVEY section 4). float64, rtol 1e-12."""
  points, depth, feats = scenes.points2d(7, N, SIZE)
  pts, f = scenes.to_torch(points), scenes.to_torch(feats).requires_grad_()
  vs = torch.zeros(N, dtype=torch.float64, requires_grad=True)
  out = rasterize(pts, scenes.to_torch(depth), f, SIZE, RasterConfig(tile_size=16),
                  visibility_sink=vs)
  gf, vis = torch.autograd.grad(out.image.sum(), [f, vs])
  assert vis.sum() > 0 and (vis >= 0).all()
  for c in range(3):
    torch.testing.assert_close(gf[:, c], vis, rtol=1e-12, atol=1e-15)


def test_quantile_mode_passes_no_gradient():
  """The median (non-blending) pass is forward only: its outputs are
  detached, so the points get no gradient from it."""
  points, depth, feats = scenes.points2d(2, 60, (32, 24))
  pts = scenes.to_torch(points).requires_grad_()
  config = RasterConfig(tile_size=8, use_alpha_blending=False,
                        saturate_threshold=0.5)
  out = rasterize(pts, scenes.to_torch(depth), scenes.to_torch(feats), (32, 24),
                  config)
  assert not out.image.requires_grad and not out.image_weight.requires_grad
  assert out.image.abs().sum() > 0


def test_backward_rows_count_inside_pixels_only():
  """On a partial edge tile, pixels past the image add nothing to a
  slot's rows: the plain backward of a frame equals that of the same
  scene with the outside pixels' cotangents already zero."""
  size = (62, 45)
  points, depth, feats = scenes.points2d(3, 200, size)
  config = RasterConfig(tile_size=8)
  pts, f = scenes.to_torch(points), scenes.to_torch(feats)
  mapping = map_to_tiles(pts, scenes.to_torch(depth), size, config)
  image, weight = forward.rasterize_forward(pts, f, mapping, size, config)
  rng = np.random.default_rng(3)
  g_img = scenes.to_torch(rng.normal(size=tuple(image.shape)))
  g_w = scenes.to_torch(rng.normal(size=tuple(weight.shape)))
  rows = backward.raster_backward_plain(pts, f, mapping, config, image, weight,
                                        g_img, g_w, vis_row=True)
  vis_total = rows[6].sum()
  torch.testing.assert_close(vis_total, weight.sum(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("changed", ["header", "source", "other_source"])
def test_build_key_covers_headers(tmp_path, changed):
  """The built library's key changes with the source and with any
  csrc/*.cuh header, and not with another source file."""
  (tmp_path / "kernel.cu").write_text('#include "common.cuh"\n')
  (tmp_path / "common.cuh").write_text("// v1\n")
  (tmp_path / "other.cu").write_text("// other\n")
  before = cuda_build.source_digest("kernel.cu", tmp_path)
  assert cuda_build.source_digest("kernel.cu", tmp_path) == before
  target = {"header": "common.cuh", "source": "kernel.cu",
            "other_source": "other.cu"}[changed]
  (tmp_path / target).write_text((tmp_path / target).read_text() + "// v2\n")
  after = cuda_build.source_digest("kernel.cu", tmp_path)
  assert (after != before) == (changed != "other_source")


def test_package_sources_share_the_common_header():
  """Every kernel source includes raster_common.cuh, so the backward's
  replay runs the forward's arithmetic."""
  for source in ("raster_forward.cu", "raster_backward.cu", "segment_sum.cu"):
    assert '#include "raster_common.cuh"' in (cuda_build.CSRC_DIR / source).read_text()
