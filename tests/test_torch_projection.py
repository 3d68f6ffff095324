"""The port's projection, SH shading and math helpers against the JAX package.

Tolerances: float64 atol 1e-10 (the two packages run the same expression
trees; only libm rounding differs); float32 rtol 1e-5 (relative
rounding of a few dozen float32 operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu.ops import lib as jlib
from taichi_gaussian_rasterizer_tpu.ops.projection import (
    project_points as jax_project_points)
from taichi_gaussian_rasterizer_tpu.ops.sh import evaluate_sh_at as jax_evaluate_sh

from taichi_gaussian_rasterizer_tpu_torch.ops import lib
from taichi_gaussian_rasterizer_tpu_torch.ops.projection import project_to_image
from taichi_gaussian_rasterizer_tpu_torch.ops.sh import evaluate_sh_at

import torch_port_scenes as scenes


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_project_matches_jax(dtype):
  cam = scenes.camera(0, (64, 48))
  g = scenes.gaussians3d(1, 400, cam, margin=0.5)
  jg, jcam = scenes.jax_scene(cam, g, dtype)
  tg, tcam = scenes.torch_scene(cam, g, dtype)

  want = jax_project_points(*jg.shape_tensors(), jcam.T_camera_world,
                            jcam.projection, jcam.image_size, jcam.depth_range)
  got = project_to_image(tg, tcam)

  np.testing.assert_array_equal(scenes.to_numpy(got[2]), np.asarray(want[2]))
  assert 0 < int(got[2].sum()) < 400        # some culled, most in view
  tol = dict(atol=1e-10, rtol=0) if dtype == np.float64 else dict(rtol=1e-5, atol=1e-5)
  for a, b in zip(got[:2], want[:2]):
    np.testing.assert_allclose(scenes.to_numpy(a), np.asarray(b), **tol)


def test_project_gradients_match_jax():
  """Autograd through the port's projection reaches the gaussians and the
  camera with the gradients jax.grad gives (float64, rtol 1e-8)."""
  cam = scenes.camera(2, (64, 48))
  g = scenes.gaussians3d(3, 60, cam)
  cot = np.random.default_rng(4).normal(size=(60, 7))
  jg, jcam = scenes.jax_scene(cam, g, np.float64)

  def jloss(pos, log_s, rot, alpha_logit, T, proj):
    pts, depth, _ = jax_project_points(pos, log_s, rot, alpha_logit, T, proj,
                                       jcam.image_size, jcam.depth_range)
    return jnp.sum(pts * cot) + jnp.sum(depth)

  want = jax.jit(jax.grad(jloss, argnums=range(6)))(
      *jg.shape_tensors(), jcam.T_camera_world, jcam.projection)

  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  leaves = [x.requires_grad_() for x in (*tg.shape_tensors(),
                                         tcam.T_camera_world, tcam.projection)]
  pts, depth, _ = project_to_image(tg, tcam)
  (torch.sum(pts * scenes.to_torch(cot)) + depth.sum()).backward()
  for leaf, w in zip(leaves, want):
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_evaluate_sh_matches_jax(degree):
  rng = np.random.default_rng(degree)
  sh = rng.uniform(size=(200, 3, (degree + 1) ** 2)) - 0.5
  pos = rng.normal(size=(200, 3)) * 4
  cam_pos = rng.normal(size=3)
  want = jax_evaluate_sh(jnp.asarray(sh), jnp.asarray(pos), jnp.asarray(cam_pos))
  got = evaluate_sh_at(scenes.to_torch(sh), scenes.to_torch(pos),
                       scenes.to_torch(cam_pos))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)


def test_lib_matches_jax():
  rng = np.random.default_rng(7)
  q = rng.normal(size=(50, 4))
  v = np.concatenate([rng.normal(size=(49, 3)), np.zeros((1, 3))])
  x = rng.uniform(0.01, 0.99, size=50)
  depth = rng.uniform(0.2, 90, size=50)
  r, tr = rng.normal(size=(3, 3)), rng.normal(size=3)
  pairs = [
      (lib.quat_to_mat(scenes.to_torch(q)), jlib.quat_to_mat(jnp.asarray(q))),
      (lib.safe_normalize(scenes.to_torch(v)), jlib.safe_normalize(jnp.asarray(v))),
      (lib.inverse_sigmoid(lib.sigmoid(scenes.to_torch(x))),
       jlib.inverse_sigmoid(jlib.sigmoid(jnp.asarray(x)))),
      (lib.gaussian_scale_factor(scenes.to_torch(x), 1 / 255),
       jlib.gaussian_scale_factor(jnp.asarray(x), 1 / 255)),
      (lib.ndc_depth(scenes.to_torch(depth), 0.1, 100.0),
       jlib.ndc_depth(jnp.asarray(depth), 0.1, 100.0)),
      (lib.inverse_ndc_depth(scenes.to_torch(x), 0.1, 100.0),
       jlib.inverse_ndc_depth(jnp.asarray(x), 0.1, 100.0)),
      (lib.join_rt(scenes.to_torch(r), scenes.to_torch(tr)),
       jlib.join_rt(jnp.asarray(r), jnp.asarray(tr))),
  ]
  for got, want in pairs:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=1e-12)
  rot, trans = lib.split_rt(lib.join_rt(scenes.to_torch(r), scenes.to_torch(tr)))
  np.testing.assert_array_equal(rot.numpy(), r)
  np.testing.assert_array_equal(trans.numpy(), tr)
