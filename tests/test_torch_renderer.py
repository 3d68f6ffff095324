"""The port's render path (`render_gaussians`, its gradients for every
`Gaussians3D` tensor, and `render_with_heuristics`) against the JAX
package, and the port's import hygiene.

Tolerances:
* float64: every image atol 1e-8 (image, weight, depth, depth variance,
  median depth); the in-view mask and the projected points as in
  test_torch_projection.
* float32 (JAX with exact_features and deterministic): image and weight
  p99.9 |diff| <= 1e-3 and max |diff| <= 2e-2 -- a gate at
  alpha_threshold can flip on a borderline pixel.
* gradients, float64 against jax.grad of the JAX render: rtol 1e-6 and
  atol 1e-8 of the largest |gradient| of each tensor (the raster
  backward agrees to 1e-7, test_torch_backward; projection and SH add
  their own float64 rounding); heuristics and visibility the same. Where
  the JAX render gives a culled point a NaN gradient (its conic chain
  divides the point's zero sums by its zero sigmas), the port's is 0.

The kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import taichi_gaussian_rasterizer_tpu as tgr_jax

from taichi_gaussian_rasterizer_tpu_torch import (
    RasterConfig, render_gaussians, render_with_heuristics, viewspace_gradient)
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import backward, forward, tiles
from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import (
    random_3d_gaussians, random_camera)

import torch_port_scenes as scenes

ROOT = Path(__file__).resolve().parents[1]
SIZE = (64, 48)
SCENES = {
    "translucent": dict(seed=10, scale_factor=1.0, alpha_range=(0.1, 0.9)),
    # large opaque splats: the median crosses inside the bins and most
    # pixels saturate
    "saturating": dict(seed=11, scale_factor=3.0, alpha_range=(0.75, 0.99)),
}


def render_both(scene, dtype, use_sh, n=300):
  s = SCENES[scene]
  cam = scenes.camera(s["seed"], SIZE)
  g = scenes.gaussians3d(s["seed"] + 1, n, cam, scale_factor=s["scale_factor"],
                         alpha_range=s["alpha_range"],
                         sh_degree=3 if use_sh else None)
  jg, jcam = scenes.jax_scene(cam, g, dtype)
  tg, tcam = scenes.torch_scene(cam, g, dtype)
  kw = dict(use_sh=use_sh, render_depth=True, render_median_depth=True)
  want = tgr_jax.render_gaussians(
      jg, jcam, tgr_jax.RasterConfig(tile_size=8, points_per_chunk=8,
                                     exact_features=True, deterministic=True),
      **kw)
  got = render_gaussians(tg, tcam, RasterConfig(tile_size=8), **kw)
  return got, want


@pytest.mark.parametrize("scene,use_sh", [
    ("translucent", False), ("translucent", True), ("saturating", True)])
def test_render_gaussians_float64_matches_jax(scene, use_sh):
  got, want = render_both(scene, np.float64, use_sh)
  assert got.image.shape == (SIZE[1], SIZE[0], 3)
  np.testing.assert_array_equal(got.points_in_view.numpy(),
                                np.asarray(want.points_in_view))
  np.testing.assert_allclose(got.gaussians2d.numpy(), np.asarray(want.gaussians2d),
                             atol=1e-10, rtol=0)
  for name in ("image", "image_weight", "depth", "depth_var", "median_depth"):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)),
                               atol=1e-8, rtol=0, err_msg=name)
  weight = got.image_weight.numpy()
  if scene == "saturating":
    assert (weight >= 0.9999).mean() > 0.5
  # the median is a depth some point really has, where any point covers
  covered = weight > 0.6
  assert covered.any() and (got.median_depth.numpy()[covered] >= 1.0).all()


def test_render_gaussians_float32_matches_jax():
  got, want = render_both("translucent", np.float32, use_sh=True)
  assert got.image.dtype == torch.float32
  for name in ("image", "image_weight"):
    diff = np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name)))
    assert np.quantile(diff, 0.999) <= 1e-3, (name, np.quantile(diff, 0.999))
    assert diff.max() <= 2e-2, (name, diff.max())


GAUSSIAN_FIELDS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


def _loss_terms(seed):
  rng = np.random.default_rng(seed)
  return (rng.normal(size=(SIZE[1], SIZE[0], 3)), rng.normal(size=(SIZE[1], SIZE[0])),
          rng.normal(size=(SIZE[1], SIZE[0])))


def _jax_loss(r, g):
  import jax.numpy as jnp
  loss = jnp.sum(r.image * g[0]) + jnp.sum(r.image_weight * g[1])
  return loss if r.depth is None else loss + jnp.sum(r.depth * g[2])


def _torch_loss(r, g):
  g = [torch.as_tensor(x) for x in g]
  loss = (r.image * g[0]).sum() + (r.image_weight * g[1]).sum()
  return loss if r.depth is None else loss + (r.depth * g[2]).sum()


def _assert_grad_close(got, want, name):
  """Rows where the JAX gradient is NaN (culled points: its conic chain
  divides their zero sums by zero sigmas) are held to 0 instead."""
  got, want = scenes.to_numpy(got), np.asarray(want)
  assert np.isfinite(got).all(), name
  bad = ~np.isfinite(want).reshape(want.shape[0], -1).all(1)
  assert (got[bad] == 0).all(), name
  got, want = got[~bad], want[~bad]
  scale = np.abs(want).max()
  assert scale > 0, name
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8 * scale, err_msg=name)


@pytest.mark.parametrize("use_sh,render_depth", [(False, True), (True, True),
                                                 (True, False)])
def test_render_gradients_float64_match_jax(use_sh, render_depth):
  """loss.backward() through render_gaussians gives every Gaussians3D
  tensor the gradient jax.grad gives through the JAX render."""
  import jax
  cam = scenes.camera(14, SIZE)
  g = scenes.gaussians3d(15, 300, cam, sh_degree=2 if use_sh else None)
  jg, jcam = scenes.jax_scene(cam, g, np.float64)
  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  terms = _loss_terms(16)
  kw = dict(use_sh=use_sh, render_depth=render_depth)
  want = jax.grad(lambda x: _jax_loss(tgr_jax.render_gaussians(
      x, jcam, tgr_jax.RasterConfig(tile_size=8, points_per_chunk=8), **kw),
      terms))(jg)
  leaves = tg.replace(**{name: getattr(tg, name).requires_grad_()
                         for name in GAUSSIAN_FIELDS})
  _torch_loss(render_gaussians(leaves, tcam, RasterConfig(tile_size=8), **kw),
              terms).backward()
  for name in GAUSSIAN_FIELDS:
    _assert_grad_close(getattr(leaves, name).grad, getattr(want, name), name)


def test_render_with_heuristics_float64_matches_jax():
  """loss, gradients, point_heuristic and point_visibility."""
  cam = scenes.camera(17, SIZE)
  g = scenes.gaussians3d(18, 300, cam, scale_factor=2.0)
  jg, jcam = scenes.jax_scene(cam, g, np.float64)
  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  terms = _loss_terms(19)
  want_loss, want_grads, want_r = tgr_jax.render_with_heuristics(
      lambda r: _jax_loss(r, terms), jg, jcam,
      tgr_jax.RasterConfig(tile_size=8, points_per_chunk=8), render_depth=True)
  loss, grads, r = render_with_heuristics(
      lambda r: _torch_loss(r, terms), tg, tcam, RasterConfig(tile_size=8),
      render_depth=True)
  np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-10)
  for name in GAUSSIAN_FIELDS:
    _assert_grad_close(getattr(grads, name), getattr(want_grads, name), name)
    assert getattr(tg, name).grad is None
  _assert_grad_close(r.point_heuristic, want_r.point_heuristic, "heuristic")
  _assert_grad_close(r.point_visibility, want_r.point_visibility, "visibility")
  assert (r.prune_cost >= 0).all() and (r.split_score >= 0).all()
  assert r.visible_mask.sum() > 0


@pytest.mark.parametrize("scene", ["translucent", "saturating"])
def test_render_visibility_and_depth16_float64_match_jax(scene):
  """compute_visibility fills point_visibility as the JAX render does, and
  use_depth16 (deterministic) renders the JAX depth16 image; float64, atol
  1e-8. 64x48 with 8x8 tiles: no partial tiles."""
  s = SCENES[scene]
  cam = scenes.camera(s["seed"] + 20, SIZE)
  g = scenes.gaussians3d(s["seed"] + 21, 300, cam, scale_factor=s["scale_factor"],
                         alpha_range=s["alpha_range"])
  jg, jcam = scenes.jax_scene(cam, g, np.float64)
  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  kw = dict(compute_visibility=True, deterministic=True)
  want = tgr_jax.render_gaussians(
      jg, jcam, tgr_jax.RasterConfig(tile_size=8, points_per_chunk=8, **kw),
      use_depth16=True)
  got = render_gaussians(tg, tcam, RasterConfig(tile_size=8, **kw), use_depth16=True)
  for name in ("image", "image_weight", "point_visibility"):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)), atol=1e-8,
                               rtol=0, err_msg=name)
  assert got.visible_mask.sum() > 0
  full = render_gaussians(tg, tcam, RasterConfig(tile_size=8, **kw))
  torch.testing.assert_close(got.image, full.image, rtol=0, atol=1e-12)


def test_rendering_detach():
  """Rendering.detach cuts every tensor, the camera's included, from the
  graph, and keeps the values."""
  cam = scenes.camera(22, SIZE)
  g = scenes.gaussians3d(23, 100, cam)
  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  tg = tg.replace(position=tg.position.requires_grad_())
  tcam = dataclasses.replace(tcam, T_camera_world=tcam.T_camera_world.requires_grad_())
  r = render_gaussians(tg, tcam, RasterConfig(tile_size=8, compute_visibility=True),
                       render_depth=True)
  assert r.image.requires_grad and r.gaussians2d.requires_grad
  d = r.detach()
  for f in dataclasses.fields(d):
    v = getattr(d, f.name)
    if isinstance(v, torch.Tensor):
      assert not v.requires_grad, f.name
      torch.testing.assert_close(v, getattr(r, f.name).detach(), rtol=0, atol=0)
  assert not d.camera.T_camera_world.requires_grad
  assert d.config == r.config and d.median_depth is None


def test_viewspace_gradient():
  grad = torch.tensor([[3.0, 4.0, 1, 1, 1, 1, 1], [0.0, -2.0, 5, 5, 5, 5, 5]])
  torch.testing.assert_close(viewspace_gradient(grad), torch.tensor([5.0, 2.0]))


def test_render_depth_channels_are_stripped():
  """render_depth prepends depth and depth^2 to the blend and takes them
  off again: the feature image is what a render without depth gives."""
  cam = scenes.camera(12, SIZE)
  g = scenes.gaussians3d(13, 200, cam)
  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  config = RasterConfig(tile_size=16)
  plain = render_gaussians(tg, tcam, config)
  with_depth = render_gaussians(tg, tcam, config, render_depth=True)
  assert plain.depth is None and plain.median_depth is None
  torch.testing.assert_close(with_depth.image, plain.image, rtol=0, atol=1e-12)
  torch.testing.assert_close(with_depth.image_weight, plain.image_weight,
                             rtol=0, atol=1e-12)


def test_config_fields_match_jax():
  """Every field of the JAX RasterConfig, with its default."""
  def defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}
  assert defaults(RasterConfig) == defaults(tgr_jax.RasterConfig)


def test_random_scene_renders_on_cpu():
  """random_camera / random_3d_gaussians from a torch.Generator give a
  scene that mostly lands in view and renders to finite images."""
  gen = torch.Generator().manual_seed(0)
  camera = random_camera(gen, image_size=(96, 64))
  scene = random_3d_gaussians(gen, 500, camera, sh_degree=1)
  assert scene.feature.shape == (500, 3, 4)
  r = render_gaussians(scene, camera, RasterConfig(), use_sh=True,
                       render_depth=True)
  assert int(r.points_in_view.sum()) > 400
  assert torch.isfinite(r.image).all() and torch.isfinite(r.depth).all()
  assert float(r.image_weight.max()) <= 1.0 and float(r.image_weight.mean()) > 0.1


def _run_python(code, **env):
  full_env = {k: v for k, v in os.environ.items()
              if k not in ("CUDA_HOME", "CUDA_PATH")}
  full_env.update(env)
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  return proc.stdout


def test_package_imports_without_jax_nvcc_or_triton():
  """Importing the port, its optimizers, the 2D renderer and the examples
  pulls in no JAX, and its kernel modules import (building nothing) on a
  machine with no nvcc and no triton."""
  out = _run_python(
      "import sys\n"
      "import taichi_gaussian_rasterizer_tpu_torch\n"
      "from taichi_gaussian_rasterizer_tpu_torch.ops.raster import backward, forward, reduce\n"
      "from taichi_gaussian_rasterizer_tpu_torch import optim, convert\n"
      "from taichi_gaussian_rasterizer_tpu_torch.models import renderer2d\n"
      "from taichi_gaussian_rasterizer_tpu_torch.examples import (\n"
      "    fit_image_gaussians, test_backward, vis_split)\n"
      "mods = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton')]\n"
      "ks = (forward.RASTER_FORWARD, backward.RASTER_BACKWARD, reduce.SEGMENT_SUM)\n"
      "print(mods, *[(k._fn, k.launch_count) for k in ks])\n",
      PATH=os.path.dirname(sys.executable))
  assert out.split() == ["[]"] + ["(None,", "0)"] * 3


def test_cpu_tensor_takes_the_plain_path():
  points, depth, feats = scenes.points2d(20, 100, (40, 24))
  pts, f = scenes.to_torch(points, np.float32), scenes.to_torch(feats, np.float32)
  config = RasterConfig(tile_size=8)
  mapping = map_to_tiles(pts, scenes.to_torch(depth, np.float32), (40, 24), config)
  before = forward.RASTER_FORWARD.launch_count
  image, weight = forward.rasterize_forward(pts, f, mapping, (40, 24), config)
  assert forward.RASTER_FORWARD.launch_count == before
  tiled, tiled_w = forward.rasterize_tiles_plain(pts, f, mapping, config)
  torch.testing.assert_close(
      image, tiles.tiles_to_image(tiled, mapping.tile_shape, 8, (40, 24)),
      rtol=0, atol=0)
  torch.testing.assert_close(
      weight, tiles.tiles_to_image(tiled_w[:, None], mapping.tile_shape, 8,
                                   (40, 24))[..., 0], rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["float64", "too_many_features", "bad_shape",
                                 "tile_size"])
def test_kernel_input_checks(bad):
  """The checks the CUDA wrappers of both raster kernels run before a
  launch, here on CPU tensors and so before any build: float32 only (a
  float64 input raises TypeError), (N, 7) points and (N, F) features with
  F >= 1, tile_size >= 1; inputs that pass them reach the launch, which
  refuses CPU tensors. No width is too many: F = 1024 passes the checks
  (the kernels blend wide features in channel chunks), F = 0 raises; no
  tile is too large or too small but an empty one."""
  size = (32, 24)
  points, depth, feats = scenes.points2d(21, 50, size, n_features=3)
  pts, f = scenes.to_torch(points, np.float32), scenes.to_torch(feats, np.float32)
  mapping = map_to_tiles(pts, scenes.to_torch(depth, np.float32), size,
                         RasterConfig(tile_size=8))

  def refused(error, match, pts, f, config=RasterConfig(tile_size=8)):
    image = torch.zeros(size[1], size[0], f.shape[-1])
    weight = torch.zeros(size[1], size[0])
    for call in (lambda: forward.rasterize_tiles_cuda(pts, f, mapping, size, config),
                 lambda: backward.raster_backward_cuda(
                     pts, f, mapping, config, image, weight, image, weight)):
      with pytest.raises(error, match=match):
        call()

  if bad == "float64":
    refused(TypeError, "float32", pts.double(), f)
  elif bad == "too_many_features":
    refused(ValueError, "CUDA tensors", pts, torch.zeros(50, 1024))
    refused(ValueError, "1 <= F", pts, torch.zeros(50, 0))
  elif bad == "tile_size":
    for ts in (1, 4, 12, 40, 64):
      refused(ValueError, "CUDA tensors", pts, f, RasterConfig(tile_size=ts))
    refused(ValueError, "at least one pixel", pts, f, RasterConfig(tile_size=0))
  else:
    refused(ValueError, r"\(N, 7\)", pts[:, :6].contiguous(), f)
