"""The port's 2D pipeline (`models.renderer2d`), the 2D helpers of
`ops.lib`, `data_types` and `utils.random_data` against the JAX package.

The render runs at 64x48 with 8x8 tiles (no partial tiles); the JAX side
runs its Pallas kernels in interpret mode and stages 8 points per chunk.

Tolerances (float64):
* projection, rotation, basis, covariance and the deterministic split:
  atol 1e-12 (the same elementwise arithmetic);
* render image and weight: atol 1e-8, as in test_torch_raster;
* gradients of every Gaussians2D field against jax.grad: rtol 1e-7 and
  atol 1e-9 of the largest |gradient| of each field, as in
  test_torch_backward (the depths get no gradient in either).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import RasterConfig as JaxRasterConfig
from taichi_gaussian_rasterizer_tpu import data_types as jax_data_types
from taichi_gaussian_rasterizer_tpu.models import renderer2d as jax_r2d
from taichi_gaussian_rasterizer_tpu.ops import lib as jax_lib
from taichi_gaussian_rasterizer_tpu.utils.random_data import (
    random_2d_gaussians as jax_random_2d_gaussians)

from taichi_gaussian_rasterizer_tpu_torch import (Gaussians2D, Gaussians3D,
                                                  RasterConfig, check_packed3d,
                                                  convert)
from taichi_gaussian_rasterizer_tpu_torch.models import renderer2d
from taichi_gaussian_rasterizer_tpu_torch.ops import lib
from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import random_2d_gaussians

import torch_port_scenes as scenes

SIZE = (64, 48)
FIELDS = ("position", "z_depth", "log_scaling", "rotation", "alpha_logit",
          "feature")


def both(seed, n=60, **kw):
  g = scenes.gaussians2d(seed, n, SIZE, **kw)
  return (jax_data_types.Gaussians2D(**{k: jnp.asarray(v) for k, v in g.items()}),
          convert.gaussians2d_from_numpy(**g, device="cpu", dtype=torch.float64))


def close(got, want, atol=1e-12):
  np.testing.assert_allclose(scenes.to_numpy(got), np.asarray(want), rtol=0,
                             atol=atol)


@pytest.mark.parametrize("fn", ["project_gaussians2d", "point_rotation",
                                "point_basis", "point_covariance"])
def test_geometry_matches_jax(fn):
  jg, tg = both(0)
  close(getattr(renderer2d, fn)(tg), getattr(jax_r2d, fn)(jg))


def test_lib_2d_helpers_match_jax():
  rng = np.random.default_rng(1)
  a, b = rng.normal(size=(10, 2)), rng.normal(size=(10, 2))
  close(lib.perp(torch.tensor(a)), jax_lib.perp(jnp.asarray(a)))
  close(lib.dot(torch.tensor(a), torch.tensor(b)),
        jax_lib.dot(jnp.asarray(a), jnp.asarray(b)))
  parts = [rng.normal(size=(10, 2)), a, b, rng.uniform(size=10)]
  packed = lib.pack_g2d(*map(torch.tensor, parts))
  close(packed, jax_lib.pack_g2d(*map(jnp.asarray, parts)))
  for got, want in zip(lib.unpack_g2d(packed), parts):
    close(got, want, atol=0)


def test_uniform_split_deterministic_path_matches_jax():
  """random_axis=False and depth_noise=0 draw nothing that matters: the
  split gaussians equal the JAX package's."""
  jg, tg = both(2)
  want = jax_r2d.uniform_split_gaussians2d(jax.random.PRNGKey(0), jg, n=3,
                                           depth_noise=0.0)
  got = renderer2d.uniform_split_gaussians2d(torch.Generator().manual_seed(0),
                                             tg, n=3, depth_noise=0.0)
  for k in FIELDS:
    close(getattr(got, k), getattr(want, k))


def _pairs(split, n):
  return {k: getattr(split, k).reshape(n, 2, -1) for k in FIELDS}


def test_uniform_split_random_axis_places_copies_on_an_axis():
  """Each point becomes two copies at +-0.7 scale along one of its axes;
  that axis's scale shrinks by sqrt(2)/2, the other stays."""
  _, tg = both(3)
  n = tg.position.shape[0]
  got = _pairs(renderer2d.uniform_split_gaussians2d(
      torch.Generator().manual_seed(5), tg, random_axis=True), n)
  offsets = got["position"] - tg.position[:, None, :]
  torch.testing.assert_close(offsets[:, 0], -offsets[:, 1], rtol=0, atol=1e-12)
  basis = renderer2d.point_basis(tg)                          # columns = axes
  coords = torch.linalg.solve(basis, offsets[:, 1, :, None])[..., 0]
  axis = coords.abs().argmax(dim=1)
  torch.testing.assert_close(coords.abs().amax(dim=1), torch.full((n,), 0.7,
                             dtype=torch.float64))
  assert (coords.abs().amin(dim=1) < 1e-9).all()
  ratio = torch.exp(got["log_scaling"][:, 0] - tg.log_scaling)
  want = torch.ones(n, 2, dtype=torch.float64)
  want[torch.arange(n), axis] = np.sqrt(2) / 2
  torch.testing.assert_close(ratio, want)
  assert 0 < int(axis.sum()) < n                  # both axes get chosen
  for k in ("rotation", "alpha_logit", "feature"):
    torch.testing.assert_close(got[k][:, 0], getattr(tg, k), rtol=0, atol=0)
  assert (got["z_depth"] != tg.z_depth[:, None]).all()


def test_random_split_shapes():
  _, tg = both(4)
  n = tg.position.shape[0]
  split = renderer2d.split_gaussians2d(torch.Generator().manual_seed(6), tg, n=3)
  for k in FIELDS:
    assert getattr(split, k).shape == (3 * n,) + getattr(tg, k).shape[1:]
  got = _pairs(renderer2d.split_gaussians2d(torch.Generator().manual_seed(6), tg), n)
  torch.testing.assert_close(got["log_scaling"],
                             (tg.log_scaling + np.log(1 / np.sqrt(2)))[:, None]
                             .expand(n, 2, 2))
  torch.testing.assert_close(got["feature"][:, 1], tg.feature, rtol=0, atol=0)
  assert (got["z_depth"] >= 1e-6).all()


def _loss_terms(seed):
  rng = np.random.default_rng(seed)
  return rng.normal(size=(SIZE[1], SIZE[0], 3)), rng.normal(size=(SIZE[1], SIZE[0]))


@pytest.mark.parametrize("antialias", [False, True])
def test_render_gaussians_and_gradients_match_jax(antialias):
  jg, tg = both(7, n=120, scale_factor=1.5)
  g1, g2 = _loss_terms(8)

  def jax_loss(g):
    out = jax_r2d.render_gaussians(g, SIZE, JaxRasterConfig(
        tile_size=8, points_per_chunk=8, antialias=antialias))
    return jnp.sum(out.image * g1) + jnp.sum(out.image_weight * g2), out

  (_, want), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(jg)
  leaves = tg.replace(**{k: getattr(tg, k).requires_grad_() for k in FIELDS})
  got = renderer2d.render_gaussians(leaves, SIZE,
                                    RasterConfig(tile_size=8, antialias=antialias))
  close(got.image, want.image, atol=1e-8)
  close(got.image_weight, want.image_weight, atol=1e-8)
  ((got.image * torch.tensor(g1)).sum()
   + (got.image_weight * torch.tensor(g2)).sum()).backward()
  for k in FIELDS:
    g, w = getattr(leaves, k).grad, np.asarray(getattr(want_grads, k))
    if k == "z_depth":
      assert g is None or (g == 0).all()
      assert (w == 0).all()
      continue
    scale = np.abs(w).max()
    assert scale > 0, k
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=1e-9 * scale,
                               err_msg=k)


def test_data_types_2d_helpers():
  _, tg = both(9, n=10)
  both_g = tg.concat(tg[:4])
  assert both_g.position.shape == (14, 2) and both_g.feature.shape == (14, 3)
  scaled = tg.set_scaling(tg.scaling * 2)
  torch.testing.assert_close(scaled.log_scaling, tg.log_scaling + np.log(2))
  g3 = Gaussians3D(position=torch.zeros(3, 3), log_scaling=torch.zeros(3, 3),
                   rotation=torch.zeros(3, 4), alpha_logit=torch.zeros(3, 1),
                   feature=torch.zeros(3, 3))
  assert g3.concat(g3).position.shape == (6, 3)
  check_packed3d(g3.packed())
  with pytest.raises(ValueError):
    check_packed3d(torch.zeros(3, 7))


def test_random_2d_gaussians():
  """From a torch.Generator: the JAX function's shapes and ranges, and the
  same scene for the same seed."""
  g = random_2d_gaussians(torch.Generator().manual_seed(0), 500, (96, 64),
                          alpha_range=(0.7, 0.9))
  again = random_2d_gaussians(torch.Generator().manual_seed(0), 500, (96, 64),
                              alpha_range=(0.7, 0.9))
  want = jax.eval_shape(lambda: jax_random_2d_gaussians(
      jax.random.PRNGKey(0), 500, (96, 64)))
  assert isinstance(g, Gaussians2D)
  for k in FIELDS:
    assert getattr(g, k).shape == getattr(want, k).shape, k
    torch.testing.assert_close(getattr(g, k), getattr(again, k), rtol=0, atol=0)
  assert (g.position >= 0).all() and (g.position[:, 0] <= 96).all()
  assert (g.position[:, 1] <= 64).all()
  assert ((g.z_depth >= 0) & (g.z_depth <= 1)).all()
  assert ((g.opacity >= 0.7 - 1e-6) & (g.opacity <= 0.9 + 1e-6)).all()
  torch.testing.assert_close(torch.linalg.vector_norm(g.rotation, dim=1),
                             torch.ones(500))
