"""The port's 2D trainer (`examples.fit_image_gaussians`) against the JAX
package's, and the port's mirror of tests/test_fit_image.py.

Training steps from the same numpy init at a fixed point count, on a
64x48 target with 16x16 tiles (a tile multiple: both packages' visibility
counts the same pixels):

* float64, 3 steps: the port's `train_epoch` against the JAX package's
  step (its `train_epoch` body: project, map, rasterize with both sinks,
  sigmoid, MSE, `jax.value_and_grad`, `ParameterClass.step` with
  `point_basis`, the clamps), driven step by step, because the JAX
  `train_epoch` itself runs only in float32: its `lax.scan` carries a
  float32 heuristic accumulator, which float64 sinks would promote.
  Parameters, moments, the shared optimizer state, the loss, the summed
  heuristics and the last visibility agree to rtol 1e-6, with atol 1e-9
  of each array's largest |value| (the gradients agree to 1e-7 in float64,
  test_torch_backward, and both steps take them in float32).
* float32, 3 steps: the port against the JAX `train_epoch` itself (its
  exact float32 paths): the loss to rtol 1e-5, the summed heuristics and
  the last visibility to relative L2 1e-3, and each parameter to relative
  L2 1e-2. The parameters are looser because LaProp divides each gradient
  by its running RMS: a near-zero gradient whose float32 value differs
  between the two packages (the JAX kernels sum in bf16-split passes)
  moves its parameter by up to a whole learning-rate step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import RasterConfig as JaxRasterConfig
from taichi_gaussian_rasterizer_tpu.examples import fit_image_gaussians as jfit
from taichi_gaussian_rasterizer_tpu.models.renderer2d import (
    point_basis as jax_point_basis, project_gaussians2d as jax_project)
from taichi_gaussian_rasterizer_tpu.ops.mapper import map_to_tiles as jax_map_to_tiles
from taichi_gaussian_rasterizer_tpu.ops.raster import (
    rasterize_with_tiles as jax_rasterize_with_tiles)

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig, convert
from taichi_gaussian_rasterizer_tpu_torch.examples import fit_image_gaussians as tfit

import torch_port_scenes as scenes

SIZE = (64, 48)
KEYS = tfit.TENSOR_KEYS


def test_make_epochs_matches_jax():
  for total in (60, 100, 1000, 3777):
    assert tfit.make_epochs(total, 10, 100) == jfit.make_epochs(total, 10, 100)
    assert sum(tfit.make_epochs(total, 10, 100)) == total


@pytest.mark.parametrize("descending", [False, True])
def test_take_n_matches_jax(descending):
  t = np.random.default_rng(0).permutation(50).astype(np.float64)
  for n in (0, 7, 50, 60):
    got = tfit.take_n(torch.tensor(t), n, descending=descending)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), jfit.take_n(t, n, descending))


def test_take_n_is_stable_on_ties():
  t = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0])
  assert tfit.take_n(t, 3).tolist() == [True, True, False, True, False]
  assert tfit.take_n(t, 2, descending=True).tolist() == [True, False, True,
                                                         False, False]


@pytest.mark.parametrize("n,target,n_prune", [(100, 150, 5), (100, 100, 10),
                                              (100, 300, 10), (100, 90, 20)])
def test_find_split_prune_matches_jax(n, target, n_prune):
  rng = np.random.default_rng(n + target + n_prune)
  cost, score = rng.permutation(n) * 1.0, rng.permutation(n) * 1.0
  got = tfit.find_split_prune(n, target, n_prune, torch.tensor(cost),
                              torch.tensor(score))
  want = jfit.find_split_prune(n, target, n_prune, cost, score)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), w)
  split, prune = got
  assert not (split & prune).any()


def test_synthetic_target_matches_jax():
  got = tfit.synthetic_target((96, 64), device="cpu")
  want = np.asarray(jfit.synthetic_target(jax.random.PRNGKey(1), (96, 64)))
  assert got.dtype == torch.float32 and got.shape == (64, 96, 3)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_psnr_and_log_lerp():
  a, b = np.full((4, 4, 3), 0.5), np.full((4, 4, 3), 0.6)
  np.testing.assert_allclose(float(tfit.psnr(torch.tensor(a), torch.tensor(b))),
                             float(jfit.psnr(jnp.asarray(a), jnp.asarray(b))),
                             rtol=1e-12)
  assert tfit.log_lerp(0.3, 0.1, 0.01) == jfit.log_lerp(0.3, 0.1, 0.01)


def _init(seed, dtype, n=80):
  g = scenes.gaussians2d(seed, n, SIZE, scale_factor=1.5, alpha_range=(0.5, 0.9))
  ref = np.random.default_rng(seed + 1).uniform(size=(SIZE[1], SIZE[0], 3))
  jg = jfit.tensors_to_gaussians({k: jnp.asarray(v, dtype) for k, v in g.items()})
  tg = convert.gaussians2d_from_numpy(**g, device="cpu",
                                     dtype=scenes.TORCH_DTYPE[dtype])
  return (jfit.make_parameter_class(jg), jnp.asarray(ref, dtype),
          tfit.make_parameter_class(tg), scenes.to_torch(ref, dtype))


def _jax_steps(params, ref, config, n_steps):
  """The JAX train_epoch's step, step by step, with float64 sinks."""
  def loss_fn(tensors, sink, vsink):
    g = jfit.tensors_to_gaussians(tensors)
    packed = jax_project(g)
    mapping = jax_map_to_tiles(packed, jnp.clip(g.z_depth.reshape(-1), 0.0, 1.0),
                               SIZE, config)
    out = jax_rasterize_with_tiles(packed, g.feature, mapping, SIZE, config,
                                   heuristic_sink=sink, visibility_sink=vsink)
    image = jax.nn.sigmoid(out.image)
    return jnp.mean((image - ref) ** 2), image

  grad_fn = jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)
  n = params.num_points
  heur_acc, losses = jnp.zeros((n, 2)), []
  for _ in range(n_steps):
    (loss, _), (grads, heur, vis) = grad_fn(
        {k: params.tensors[k] for k in KEYS}, jnp.zeros((n, 2)), jnp.zeros(n))
    basis = jax_point_basis(jfit.tensors_to_gaussians(params.tensors))
    params = params.step(grads, visibility=vis, basis=basis)
    rot = params.tensors["rotation"]
    params = params.replace_tensors(
        rotation=rot / jnp.linalg.norm(rot, axis=1, keepdims=True),
        log_scaling=jnp.clip(params.tensors["log_scaling"], -5, 5))
    heur_acc, losses = heur_acc + heur, losses + [loss]
  return params, heur_acc, vis, jnp.mean(jnp.stack(losses))


def _assert_close(got, want, name, rtol=1e-6):
  got, want = scenes.to_numpy(got), np.asarray(want)
  scale = np.abs(want).max()
  assert scale > 0 and np.isfinite(got).all(), name
  np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9 * scale, err_msg=name)


def test_train_epoch_float64_matches_jax():
  jp, jref, tp, tref = _init(3, np.float64)
  config = dict(tile_size=16, compute_point_heuristic=True)
  jp, jheur, jvis, jloss = _jax_steps(
      jp, jref, JaxRasterConfig(points_per_chunk=8, **config), 3)
  tp, image, theur, tvis, tloss, overflow = tfit.train_epoch(
      tp, tref, SIZE, RasterConfig(**config), epoch_size=3)
  assert image.shape == (SIZE[1], SIZE[0], 3) and not bool(overflow)
  for k in KEYS:
    if k == "z_depth":    # no gradient reaches the depths: they stay put
      continue
    _assert_close(tp.tensors[k], jp.tensors[k], k)
    _assert_close(tp.state[k].m, jp.state[k].m, f"{k}.m")
    _assert_close(tp.state[k].v, jp.state[k].v, f"{k}.v")
  np.testing.assert_array_equal(tp.tensors["z_depth"].numpy(),
                                np.asarray(jp.tensors["z_depth"]))
  _assert_close(tp.total_weight, jp.total_weight, "total_weight")
  _assert_close(tp.running_vis, jp.running_vis, "running_vis")
  _assert_close(theur, jheur, "heuristics")
  _assert_close(tvis, jvis, "visibility")
  np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


def test_train_epoch_float32_matches_jax_train_epoch():
  jp, jref, tp, tref = _init(4, np.float32)
  config = dict(tile_size=16, compute_point_heuristic=True)
  jp, _, jheur, jvis, jloss, _ = jfit.train_epoch(
      jp, jref, SIZE, JaxRasterConfig(points_per_chunk=8, exact_features=True,
                                      exact_slot_gradients=True,
                                      deterministic=True, **config),
      epoch_size=3)
  tp, _, theur, tvis, tloss, _ = tfit.train_epoch(
      tp, tref, SIZE, RasterConfig(**config), epoch_size=3)
  for k in KEYS:
    got, want = tp.tensors[k].numpy(), np.asarray(jp.tensors[k])
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want), k
  np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
  for name, got, want in (("heuristics", theur, jheur), ("visibility", tvis, jvis)):
    got, want = got.numpy(), np.asarray(want)
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want), name
  assert tvis.dtype == torch.float32 and (tvis >= 0).all()


def test_fit_image_converges():
  """The mirror of tests/test_fit_image.py::test_fit_image_converges."""
  ref = tfit.synthetic_target((96, 64), device="cpu")
  config = RasterConfig(tile_size=16, compute_point_heuristic=True)
  logs, history = [], []
  params, image = tfit.fit(ref, n=150, target=400, total_iters=80,
                           config=config, seed=0, device="cpu",
                           log=logs.append, history=history)
  final_psnr = float(tfit.psnr(image, ref))
  assert final_psnr > 18, f"expected convergence, got psnr {final_psnr}"
  assert params.num_points == 400
  assert torch.isfinite(params.tensors["position"]).all()
  # optimizer state stayed in sync through split/prune
  for s in params.state.values():
    assert s.m.shape[0] == s.v.shape[0] == 400
  assert params.total_weight.shape == (400,) == params.running_vis.shape
  assert len(logs) > 2 and history[-1]["psnr"] > history[0]["psnr"]
  assert all(h["split"] > 0 for h in history[:-1])
