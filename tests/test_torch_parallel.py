"""The port's `parallel/` on torch.distributed against the single-process
port and against the JAX package's `parallel/`, run on `make_mesh(4)` of
the virtual 8-device CPU mesh (tests/conftest.py), with the same numpy
inputs: the ten cases of tests/test_parallel.py, and the module's
refusals of what it cannot split.

The distributed side is one gloo world of 4 spawned ranks
(tests/torch_parallel_workers.py, torch only): its own `file://`
rendezvous under a temporary directory, a 60 s collective timeout, and a
time limit on the whole world, after which the ranks are terminated.
The ranks run every case once, while the JAX side compiles, and the tests
read their results. Subgroups from `make_mesh(2)` and `make_mesh(1)` run
the identical-camera step on worlds of 2 and 1.

Everything is float64, which the JAX functions take (their Pallas
kernels run in interpret mode, as the JAX package's tests run them).
Tolerances:
* dp_train_step, identical cameras: every replica equals rank 0's. With
  unit weights (no visibility) the steps of worlds 4, 2 and 1 are equal
  bit for bit (equal summands averaged over the ranks: gloo adds them
  exactly here). With visibility and VisibilityAwareAdam the world-4 and
  world-1 parameters agree to rtol 1e-10 and not bit for bit: the step
  sums the visibility over the ranks, as the JAX step psums it, and the
  visibility-aware step's 1 / (visibility + smooth) scale cancels in Adam
  only to rounding. Distinct cameras: the loss is the mean of the single-process
  losses and the step the single-process step on the mean of the
  single-process gradients, rtol 1e-10. Against the JAX step: loss rtol
  1e-10, parameters rtol 1e-6 (test_torch_optim's step parity).
* pp_project: against the single-process projection rtol 1e-12 (CPU
  elementwise ops are not bitwise across tensor sizes) and in_view equal;
  against JAX atol 1e-10 (test_torch_projection). Gradients rtol 1e-10
  against the single process, rtol 1e-8 against jax.grad.
* images, weights and visibility atol 1e-8: the stripe shift can
  re-round a mean's offset inside its tile (test_torch_raster's float64
  tolerance against JAX). tp_rasterize's gradients are held to the
  single-process port's; the JAX comparison of stripe gradients is
  tp_train_step's.
* losses rtol 1e-10; per-point gradients, heuristics and visibility
  from the training steps rtol 1e-6 with atol 1e-8 of the largest
  |value| (test_torch_renderer).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import RasterConfig as JaxRasterConfig
from taichi_gaussian_rasterizer_tpu import parallel as jpar
from taichi_gaussian_rasterizer_tpu.optim import (
    ParameterClass as JaxParameterClass,
    VisibilityAwareAdam as JaxVisibilityAwareAdam)

from taichi_gaussian_rasterizer_tpu_torch import (CameraParams, Gaussians3D,
                                                  project_to_image,
                                                  render_gaussians)
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import rasterize
from taichi_gaussian_rasterizer_tpu_torch.optim import (ParameterClass,
                                                        VisibilityAwareAdam)
from taichi_gaussian_rasterizer_tpu_torch.parallel import (
    Mesh, assemble_stripes, balance_stripe_rows, shard_leading,
    stripe_offsets_px, stripe_row_loads, stripe_select, tp_rasterize,
    tp_train_step)

import torch_parallel_workers as workers
import torch_port_scenes as scenes

D = workers.WORLD
KEYS = workers.KEYS


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  w = workers.World(D, tmp_path_factory.mktemp("gloo_world"))
  yield w
  w.close()


@pytest.fixture(scope="module")
def jax_mesh():
  if len(jax.devices()) < D:
    pytest.skip(f"needs {D} virtual devices")
  return jpar.make_mesh(D)


def t(x):
  return torch.as_tensor(np.asarray(x))


def jcfg(**kw):
  return JaxRasterConfig(tile_size=16, points_per_chunk=8, **kw)


def assert_same_on_every_rank(res, key):
  for r in res[1:]:
    np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)


def assert_close_to_scale(got, want, name, rtol=1e-6):
  """rtol, with atol 1e-8 of the largest |want|."""
  got, want = np.asarray(got), np.asarray(want)
  scale = np.abs(want).max()
  assert scale > 0, name
  np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-8 * scale,
                             err_msg=name)


def single_raster(points, depth, feats, size, config, **kw):
  """The single-process port's frame: (RasterOut, its mapping's clip
  flag)."""
  mapping = map_to_tiles(points.detach(), t(depth), size, config)
  return rasterize(points, t(depth), feats, size, config, **kw), bool(
      mapping.overflow)


# ---- camera data parallelism --------------------------------------------------


@pytest.fixture(scope="module")
def jax_dp_step(jax_mesh):
  """JAX's dp_train_step on a dp_scene, built (and compiled) once."""
  step = jpar.dp_train_step(jax_mesh, jcfg(compute_visibility=True),
                            workers.DP_SIZE, depth_range=workers.DP_DEPTH_RANGE)

  def run(distinct):
    g, proj, t_cam, targets = workers.dp_scene(distinct)
    params = JaxParameterClass.create(
        {k: jnp.asarray(v) for k, v in g.items()}, workers.param_groups(),
        optimizer=JaxVisibilityAwareAdam)
    return step(jpar.replicate(params, jax_mesh),
                *(jpar.shard_leading(jnp.asarray(x), jax_mesh)
                  for x in (proj, t_cam, targets)))
  return run


def assert_dp_matches_jax(res, label, jax_params, jax_loss):
  np.testing.assert_allclose(res[0][f"dp.{label}.loss"], float(jax_loss),
                             rtol=1e-10)
  for k in KEYS:
    np.testing.assert_allclose(res[0][f"dp.{label}.{k}"],
                               np.asarray(jax_params.tensors[k]), rtol=1e-6,
                               atol=1e-12, err_msg=k)


def test_dp_train_step_runs_and_matches_single(world, jax_dp_step):
  """Identical cameras and targets on every rank: the replicas are equal,
  the world-4 step is the world-2 and world-1 step (bit for bit with unit
  weights, to rounding with visibility), and the JAX step agrees."""
  jax_params, jax_loss = jax_dp_step(distinct=False)
  res = world.results()
  for k in KEYS + ("loss", "running_vis"):
    for label in ("same", "plain4"):
      assert_same_on_every_rank(res, f"dp.{label}.{k}")
    np.testing.assert_array_equal(res[1][f"dp.plain2.{k}"],
                                  res[0][f"dp.plain2.{k}"], err_msg=k)
    for label in ("plain4", "plain2"):
      np.testing.assert_array_equal(res[0][f"dp.{label}.{k}"],
                                    res[0][f"dp.plain1.{k}"], err_msg=k)
  for k in KEYS + ("loss",):
    np.testing.assert_allclose(res[0][f"dp.same.{k}"], res[0][f"dp.same1.{k}"],
                               rtol=1e-10, atol=1e-14, err_msg=k)
  g = workers.dp_scene(False)[0]
  for label in ("same", "plain4"):
    assert np.abs(res[0][f"dp.{label}.position"] - g["position"]).max() > 0
  assert_dp_matches_jax(res, "same", jax_params, jax_loss)


def test_dp_distinct_cameras_reduce(world, jax_dp_step):
  """Distinct cameras and targets: the loss is the mean of the per-camera
  losses and the step is the one taken with the mean of the per-camera
  gradients and the summed visibility (each computed by the single-process
  port)."""
  jax_params, jax_loss = jax_dp_step(distinct=True)
  g, proj, t_cam, targets = workers.dp_scene(True)
  config = workers.dp_config()
  losses, grads, vis = [], {k: 0.0 for k in KEYS}, 0.0
  for i in range(D):
    leaves = {k: t(v).requires_grad_() for k, v in g.items()}
    camera = CameraParams(t(proj[i]), t(t_cam[i]), *workers.DP_DEPTH_RANGE,
                          workers.DP_SIZE)
    r = render_gaussians(Gaussians3D(**leaves), camera, config)
    mse = torch.mean((r.image - t(targets[i])) ** 2)
    mse.backward()
    losses.append(float(mse.detach()))
    grads = {k: grads[k] + leaves[k].grad for k in KEYS}
    vis = vis + r.point_visibility
  params = ParameterClass.create({k: t(v) for k, v in g.items()},
                                 workers.param_groups(), VisibilityAwareAdam)
  params.step({k: v / D for k, v in grads.items()}, visibility=vis)

  res = world.results()
  for k in KEYS + ("loss",):
    assert_same_on_every_rank(res, f"dp.distinct.{k}")
  np.testing.assert_allclose(res[0]["dp.distinct.loss"], np.mean(losses),
                             rtol=1e-10)
  for k in KEYS:
    np.testing.assert_allclose(res[0][f"dp.distinct.{k}"],
                               params.tensors[k].numpy(), rtol=1e-10,
                               atol=1e-14, err_msg=k)
  np.testing.assert_allclose(res[0]["dp.distinct.running_vis"],
                             params.running_vis.numpy(), rtol=1e-10)
  assert_dp_matches_jax(res, "distinct", jax_params, jax_loss)


# ---- point parallelism --------------------------------------------------------


def test_pp_project_matches_single_device(world, jax_mesh):
  """pp_project with N = 63 over 4 ranks (the last block is short):
  values, in_view and the gradient of a loss computed on every rank."""
  g, cam, gp, gd = workers.pp_scene()
  jg, jcam = scenes.jax_scene(cam, g, np.float64)
  project = jpar.pp_project(jax_mesh, jcfg(), cam["image_size"],
                            (cam["near"], cam["far"]))

  def jax_loss(jg):
    pts, depth, _ = project(jg, jcam.projection, jcam.T_camera_world)
    return jnp.vdot(pts, gp) + jnp.vdot(depth, gd)

  want_pts, want_depth, want_iv = project(jg, jcam.projection,
                                          jcam.T_camera_world)
  want_grads = jax.grad(jax_loss)(jg)

  tg, tcam = scenes.torch_scene(cam, g, np.float64)
  leaves = {k: getattr(tg, k).requires_grad_() for k in KEYS[:4]}
  pts1, depth1, iv1 = project_to_image(tg.replace(**leaves), tcam)
  ((pts1 * t(gp)).sum() + (depth1 * t(gd)).sum()).backward()

  res = world.results()
  for k in ("points", "depth", "in_view") + tuple(f"grad.{k}" for k in KEYS[:4]):
    assert_same_on_every_rank(res, f"pp.{k}")
  got = res[0]
  assert 0 < got["pp.in_view"].sum() < 63
  np.testing.assert_array_equal(got["pp.in_view"], iv1.numpy())
  np.testing.assert_array_equal(got["pp.in_view"], np.asarray(want_iv))
  for name, single, jx in (("points", pts1, want_pts),
                           ("depth", depth1, want_depth)):
    np.testing.assert_allclose(got[f"pp.{name}"], single.detach().numpy(),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[f"pp.{name}"], np.asarray(jx), atol=1e-10,
                               rtol=0)
  for k in KEYS[:4]:
    assert_close_to_scale(got[f"pp.grad.{k}"], leaves[k].grad.numpy(), k,
                          rtol=1e-10)
    assert_close_to_scale(got[f"pp.grad.{k}"], getattr(want_grads, k), k,
                          rtol=1e-8)


# ---- tile parallelism ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tp_rasterize(jax_mesh):
  """JAX's tp_rasterize with visibility on tp_scene(40): (image, weight,
  visibility)."""
  points, depth, feats, _ = workers.tp_scene(40)
  tp = jpar.tp_rasterize(jax_mesh, jcfg(compute_visibility=True),
                         workers.TP_SIZE)
  return tp(*(jnp.asarray(x) for x in (points, depth, feats)))


def test_tp_rasterize_matches_single_device(world, jax_tp_rasterize):
  """The 4 stripes, stacked, are the full-frame render (the port's and
  JAX's tp_rasterize); under backward every rank holds the global
  gradient of vdot(image, G), the single-process port's. (The port's
  single-process gradients are held to jax.grad in test_torch_backward
  and test_torch_renderer, and JAX's stripe gradients to the port's in
  test_tp_train_step_matches_single_device.)"""
  want_img, want_w, _ = jax_tp_rasterize
  points, depth, feats, cot = workers.tp_scene(40)
  pts, f = t(points).requires_grad_(), t(feats).requires_grad_()
  out, clipped = single_raster(pts, depth, f, workers.TP_SIZE,
                               workers.tp_config())
  assert not clipped
  (out.image * t(cot)).sum().backward()

  res = world.results()
  image = np.concatenate([r["tp_rasterize.image"] for r in res])
  weight = np.concatenate([r["tp_rasterize.weight"] for r in res])
  for got, single, jx in ((image, out.image, want_img),
                          (weight, out.image_weight, want_w)):
    np.testing.assert_allclose(got, single.detach().numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jx), atol=1e-8, rtol=0)
  for k in ("grad_points", "grad_features"):
    assert_same_on_every_rank(res, f"tp_rasterize.{k}")
  for name, single in (("grad_points", pts.grad), ("grad_features", f.grad)):
    assert_close_to_scale(res[0][f"tp_rasterize.{name}"], single.numpy(), name)


def test_tp_rasterize_visibility_psum(world, jax_tp_rasterize):
  """The visibility all-reduced over the stripes is the single-frame
  visibility, on every rank."""
  config = workers.tp_config(compute_visibility=True)
  want_vis = jax_tp_rasterize[2]
  points, depth, feats, _ = workers.tp_scene(40)
  out, _ = single_raster(t(points), depth, t(feats), workers.TP_SIZE, config)
  res = world.results()
  assert_same_on_every_rank(res, "tp_rasterize.vis")
  vis = res[0]["tp_rasterize.vis"]
  assert (vis > 0).sum() > workers.TP_N // 2
  np.testing.assert_allclose(vis, out.visibility.numpy(), atol=1e-8, rtol=0)
  np.testing.assert_allclose(vis, np.asarray(want_vis), atol=1e-8, rtol=0)


def single_train(points, depth, feats, target, size, config):
  """The single-process training frame: loss and the gradients of points,
  features and the two sinks."""
  n = points.shape[0]
  leaves = [t(points).requires_grad_(), t(feats).requires_grad_(),
            torch.zeros(n, 2, dtype=torch.float64, requires_grad=True),
            torch.zeros(n, dtype=torch.float64, requires_grad=True)]
  out, clipped = single_raster(leaves[0], depth, leaves[1], size, config,
                               heuristic_sink=leaves[2],
                               visibility_sink=leaves[3])
  assert not clipped
  loss = torch.sum((out.image - t(target)) ** 2)
  grads = torch.autograd.grad(loss, leaves, allow_unused=True)
  return (float(loss.detach()),
          *(None if g is None else g.numpy() for g in grads))


def test_tp_train_step_matches_single_device(world, jax_mesh):
  """local_points = 64 < N: loss, gradients, heuristics and visibility
  against the single-process training frame and the JAX step."""
  points, depth, feats, target = workers.tp_scene(41)
  step = jpar.tp_train_step(jax_mesh, jcfg(compute_point_heuristic=True),
                            workers.TP_SIZE, local_points=64)
  want = step(*(jnp.asarray(x) for x in (points, depth, feats, target)))
  loss1, *single = single_train(points, depth, feats, target, workers.TP_SIZE,
                                workers.tp_config(compute_point_heuristic=True))
  res = world.results()
  names = ("grad_points", "grad_features", "heuristics", "vis")
  for k in ("loss", "overflow") + names:
    assert_same_on_every_rank(res, f"tp_train.{k}")
  got = res[0]
  assert got["tp_train.overflow"] == 0 and int(want[4]) == 0
  np.testing.assert_allclose(got["tp_train.loss"], loss1, rtol=1e-10)
  np.testing.assert_allclose(got["tp_train.loss"], float(want[0]), rtol=1e-10)
  jax_values = (*want[1], want[2], want[3])
  for name, s, jx in zip(names, single, jax_values):
    assert_close_to_scale(got[f"tp_train.{name}"], s, name)
    assert_close_to_scale(got[f"tp_train.{name}"], jx, name)


def test_tp_train_step_overflow_flag(world, jax_mesh):
  """local_points = 8, fewer than a stripe's relevant gaussians: the step
  counts the dropped ones, as the stripes' selections (port and JAX)
  count them."""
  points, depth, feats, target = workers.tp_scene(41)
  y0s, heights, _ = stripe_offsets_px((2,) * D, 16)
  thr = workers.tp_config().alpha_threshold
  want = sum(int(stripe_select(t(points), y0, h, 8, thr)[1])
             for y0, h in zip(y0s, heights))
  want_jax = sum(int(jpar.stripe_select(jnp.asarray(points), y0, h, 8, thr)[1])
                 for y0, h in zip(y0s, heights))
  res = world.results()
  assert_same_on_every_rank(res, "tp_train.small_overflow")
  assert res[0]["tp_train.small_overflow"] == want == want_jax > 0


def test_stripe_select_covers_mapper_acceptance():
  """stripe_select keeps every gaussian the stripe's mapper accepts but
  those whose mean lies outside the stripe and which the mapper accepts
  only at the stripe's edge (its footprint clamp keeps a span of one tile
  row): without them the stripe renders the same (atol 1e-12). Its
  indices are the relevant prefix of JAX's selection, also when it drops
  some."""
  size, stripe_h, n = (64, 128), 16, 150
  points, depth, feats = scenes.points2d(11, n, size)
  config = workers.tp_config()
  thr = config.alpha_threshold
  edge_only = 0
  for y0 in range(0, size[1], stripe_h):
    sel, dropped = stripe_select(t(points), y0, stripe_h, n, thr)
    assert int(dropped) == 0 and sel.shape[0] > 0
    local = points.copy()
    local[:, 1] -= y0
    m = map_to_tiles(t(local), t(depth), (size[0], stripe_h), config)
    accepted = np.unique(m.overlap_to_point.numpy())
    missing = sorted(set(accepted[accepted < n].tolist()) - set(sel.tolist()))
    edge_only += len(missing)
    assert all(not 0 <= local[i, 1] < stripe_h for i in missing), missing
    want = rasterize(t(local), t(depth), t(feats), (size[0], stripe_h), config)
    got = rasterize(t(local)[sel], t(depth)[sel], t(feats)[sel],
                    (size[0], stripe_h), config)
    np.testing.assert_allclose(got.image.numpy(), want.image.numpy(),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.image_weight.numpy(),
                               want.image_weight.numpy(), atol=1e-12, rtol=0)
    for local_points in (n, 10):
      sel, dropped = stripe_select(t(points), y0, stripe_h, local_points, thr)
      jsel, jdropped = jpar.stripe_select(jnp.asarray(points), float(y0),
                                          stripe_h, local_points, thr)
      assert int(dropped) == int(jdropped)
      np.testing.assert_array_equal(sel.numpy(),
                                    np.asarray(jsel)[:sel.shape[0]])
    assert int(dropped) > 0 and sel.shape[0] == 10
  assert edge_only > 0      # the scene reaches the case


def test_balanced_stripes_skewed_scene(world):
  """Balanced stripes on a scene whose overlaps crowd the top rows: the
  row loads and the partition equal JAX's, the partition is the optimal
  one and well below the equal split's bottleneck, and the assembled
  render and the balanced training step match the single-process frame
  with no dropped gaussians. (JAX's stripes are held to the port's in
  the tp_rasterize and tp_train_step tests.)"""
  points, depth, feats, target = workers.skew_scene()
  size, config = workers.SKEW_SIZE, workers.tp_config()
  loads = stripe_row_loads(t(points), t(depth), size, config)
  np.testing.assert_array_equal(loads, jpar.stripe_row_loads(
      jnp.asarray(points), jnp.asarray(depth), size, jcfg()))
  rows = balance_stripe_rows(loads, D)
  assert rows == jpar.balance_stripe_rows(loads, D)

  def bottleneck(partition):
    ends = np.cumsum(partition)
    return max(int(loads[e - r:e].sum()) for r, e in zip(partition, ends))

  optimal = min(bottleneck(np.diff((0, *cuts, 16)))
                for cuts in itertools.combinations(range(1, 16), D - 1))
  assert bottleneck(rows) == optimal
  assert bottleneck(rows) <= 0.6 * bottleneck((4,) * D), rows

  out, clipped = single_raster(t(points), depth, t(feats), size, config)
  assert not clipped
  loss1, gp1, gf1, _, _ = single_train(points, depth, feats, target, size,
                                       config)

  res = world.results()
  for k in ("loads", "rows", "loss", "grad_points", "grad_features"):
    assert_same_on_every_rank(res, f"skew.{k}")
  assert tuple(res[0]["skew.rows"]) == rows
  for name, single in (("image", out.image), ("weight", out.image_weight)):
    got = assemble_stripes(t(np.concatenate([r[f"skew.{name}"] for r in res])),
                           rows, 16).numpy()
    np.testing.assert_allclose(got, single.numpy(), atol=1e-8, rtol=0)
  assert res[0]["skew.overflow"] == 0
  np.testing.assert_allclose(res[0]["skew.loss"], loss1, rtol=1e-10)
  for name, s in (("grad_points", gp1), ("grad_features", gf1)):
    assert_close_to_scale(res[0][f"skew.{name}"], s, name)


def test_balance_stripe_rows_partitions():
  """Hand-checkable loads, as in the JAX package's test, and the same
  partitions as JAX's on seeded random loads."""
  loads = [9, 1, 1, 1, 1, 1, 1, 1]
  rows = balance_stripe_rows(loads, 3)
  assert sum(rows) == 8 and len(rows) == 3 and min(rows) >= 1
  ends = np.cumsum(rows)
  assert max(sum(loads[e - r:e]) for r, e in zip(rows, ends)) == 9
  assert balance_stripe_rows([5] * 8, 4) == (2, 2, 2, 2)
  assert balance_stripe_rows([3, 7, 2], 3) == (1, 1, 1)
  # one stripe: every row (the JAX function's greedy breaks before the
  # last row there and fails its own assert)
  assert balance_stripe_rows([6, 8], 1) == (2,)
  rng = np.random.default_rng(12)
  for _ in range(40):
    n = int(rng.integers(2, 24))
    d = int(rng.integers(2, n + 1))
    loads = rng.integers(0, 50, size=n) * (rng.uniform(size=n) < 0.8)
    assert balance_stripe_rows(loads, d) == jpar.balance_stripe_rows(loads, d)


def test_make_mesh_and_input_checks(world):
  """make_mesh refuses more ranks than the world and a CUDA mesh on a
  gloo group without a card; shard_leading, the stripe partitions and
  balance_stripe_rows refuse what they cannot split."""
  res = world.results()
  assert all(r["refusals.too_many"] and r["refusals.cuda"] for r in res)
  mesh = Mesh(None, 0, 3, "data", torch.device("cpu"))
  with pytest.raises(ValueError, match="divide"):
    shard_leading(torch.zeros(4, 2), mesh)
  np.testing.assert_array_equal(shard_leading(torch.arange(6), mesh).numpy(),
                                [0, 1])
  with pytest.raises(ValueError, match="tile-aligned"):
    tp_rasterize(mesh, workers.tp_config(), (64, 128))
  with pytest.raises(ValueError, match="3 counts"):
    tp_train_step(mesh, workers.tp_config(), (64, 128), 10, stripe_rows=(4, 4))
  with pytest.raises(ValueError, match="image height"):
    tp_rasterize(mesh, workers.tp_config(), (64, 128), stripe_rows=(4, 2, 1))
  with pytest.raises(ValueError):
    balance_stripe_rows([1, 2], 3)
