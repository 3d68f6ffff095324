"""Saturation-front truncation in the port (`probe_visit_chunks`,
`truncate_mapping`, `rasterize_with_tiles(visit_chunks=...)`,
`TruncationGuard`) against the port's untruncated render and against the
JAX package's truncation (its Pallas kernels in interpret mode on the
CPU, as its own tests run them).

The scenes are the JAX package's truncation scenes, made with numpy: 128
opaque gaussians (alpha 0.9, sigma 10) piled along a band of a 64x32
image, tile 16, 8 points per chunk, saturate_threshold 0.999, so that the
front tiles saturate early and most of their bins lie behind the front.
The image is whole tiles, so both packages count the same pixels.

Tolerances (float64):
* probe: visit_chunks and visit_capacity equal JAX's exactly;
* truncated image and weight: atol 1e-12 against the port's untruncated
  render, atol 1e-8 against JAX's truncated render. Not bitwise on the
  CPU: the plain forward sums each pixel over a padded bin with an
  einsum, and bins of another length can change the order of its sums
  (zero terms included). The bitwise check belongs to the card
  (tests/test_torch_cuda.py, chip_smoke.py phase 8);
* gradients, heuristics and sink visibility: rtol 1e-12 (atol 1e-14 for
  the entries that are 0) against the port's untruncated ones, rtol 1e-7
  (atol 1e-9) against JAX's, the port's backward tolerance against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import RasterConfig as JaxRasterConfig
from taichi_gaussian_rasterizer_tpu.ops.mapper import map_to_tiles as jax_map_to_tiles
from taichi_gaussian_rasterizer_tpu.ops.raster import function as jax_function

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig, TruncationGuard
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
    probe_visit_chunks, rasterize_forward, rasterize_with_tiles,
    truncate_mapping)
from taichi_gaussian_rasterizer_tpu_torch.ops.raster.function import (
    tile_front_chunks)

import torch_port_scenes as scenes

SIZE = (64, 32)
N = 128
CFG = dict(tile_size=16, points_per_chunk=8, saturate_threshold=0.999)


def opaque_pile(seed, n=N, alpha=0.9):
  """The JAX truncation tests' scene: opaque gaussians along y = 16,
  spread over x, at increasing depths."""
  rng = np.random.default_rng(seed)
  points = np.concatenate([
      np.stack([8.0 + 48.0 * rng.uniform(size=n),
                16.0 + 3.0 * rng.normal(size=n)], axis=1),
      np.tile([[1.0, 0.0]], (n, 1)),
      np.full((n, 2), 10.0),
      np.full((n, 1), alpha)], axis=1)
  return points, np.linspace(0.1, 0.9, n), rng.uniform(size=(n, 3))


def port_frame(points, depth, config, size=SIZE):
  pts, d = scenes.to_torch(points), scenes.to_torch(depth)
  return pts, map_to_tiles(pts, d, size, config)


def jax_frame(points, depth, config, size=SIZE):
  jpts = jnp.asarray(points)
  return jpts, jax_map_to_tiles(jpts, jnp.asarray(depth), size, config)


def sink_grads(render, pts, feats):
  """Gradients of sum(image^2) + sum(weight) wrt points, features, the
  heuristic sink and the visibility sink (port)."""
  pts = pts.clone().requires_grad_()
  feats = feats.clone().requires_grad_()
  hs = torch.zeros(pts.shape[0], 2, dtype=pts.dtype, requires_grad=True)
  vs = torch.zeros(pts.shape[0], dtype=pts.dtype, requires_grad=True)
  out = render(pts, feats, hs, vs)
  loss = (out.image ** 2).sum() + out.image_weight.sum()
  return out, torch.autograd.grad(loss, [pts, feats, hs, vs])


@pytest.mark.parametrize("margin", [0, 1])
def test_probe_matches_jax(margin):
  points, depth, _ = opaque_pile(31)
  config = RasterConfig(**CFG)
  pts, mapping = port_frame(points, depth, config)
  jpts, jmap = jax_frame(points, depth, JaxRasterConfig(**CFG))
  np.testing.assert_array_equal(mapping.tile_ranges.numpy(),
                                np.asarray(jmap.tile_ranges))
  visit, cap = probe_visit_chunks(pts, mapping, config, margin_chunks=margin)
  jvisit, jcap = jax_function.probe_visit_chunks(
      jpts, jmap, JaxRasterConfig(**CFG), margin_chunks=margin)
  assert visit.dtype == torch.int32
  np.testing.assert_array_equal(visit.numpy(), np.asarray(jvisit))
  assert cap == jcap
  assert cap < mapping.overlap_to_point.shape[0]     # truncation drops slots


@pytest.mark.parametrize("seed", [31, 41])
def test_plain_front_matches_jax_satiters(seed):
  """The plain forward's per-tile front, converted to chunks, equals the
  JAX kernel's signed satiters on every non-empty tile."""
  points, depth, feats = opaque_pile(seed)
  config = RasterConfig(**CFG)
  pts, mapping = port_frame(points, depth, config)
  *_, front = rasterize_forward(pts, scenes.to_torch(feats), mapping, SIZE,
                                config, tile_front=True)
  jcfg = JaxRasterConfig(**CFG)
  jpts, jmap = jax_frame(points, depth, jcfg)
  satiters = np.asarray(jax_function._forward_impl(
      jcfg, False, jpts, jnp.asarray(feats), jmap)[4])
  bins = (mapping.tile_ranges[:, 1] - mapping.tile_ranges[:, 0]).numpy()
  chunks = tile_front_chunks(front, mapping, config.points_per_chunk).numpy()
  assert (front.numpy()[bins == 0] == 0).all()
  np.testing.assert_array_equal(chunks[bins > 0], satiters[bins > 0])
  assert (chunks > 0).any() and (chunks < 0).any()   # both kinds of tile


def test_partial_edge_tiles_front_no_longer_than_jax():
  """On a 60x26 image the right and bottom tiles are partial. The
  forward's front counts the pixels inside the image only; the JAX kernel
  waits for the tile's pixels past the image too, so the port's front is
  never longer. The probe waits for them as JAX does: its visit_chunks
  equal JAX's, and the truncated render is exact."""
  size = (60, 26)
  points, depth, feats = opaque_pile(51)
  config = RasterConfig(**CFG)
  pts, mapping = port_frame(points, depth, config, size)
  f = scenes.to_torch(feats)
  *_, front = rasterize_forward(pts, f, mapping, size, config, tile_front=True)
  jcfg = JaxRasterConfig(**CFG)
  jpts, jmap = jax_frame(points, depth, jcfg, size)
  satiters = np.asarray(jax_function._forward_impl(
      jcfg, False, jpts, jnp.asarray(feats), jmap)[4])
  bins = (mapping.tile_ranges[:, 1] - mapping.tile_ranges[:, 0]).numpy()
  chunks = tile_front_chunks(front, mapping, config.points_per_chunk).numpy()
  live = bins > 0
  assert (np.abs(chunks[live]) <= np.abs(satiters[live])).all()
  assert (np.abs(chunks[live]) < np.abs(satiters[live])).any()
  visit, cap = probe_visit_chunks(pts, mapping, config, margin_chunks=0)
  jvisit, jcap = jax_function.probe_visit_chunks(jpts, jmap, jcfg, margin_chunks=0)
  np.testing.assert_array_equal(visit.numpy(), np.asarray(jvisit))
  assert cap == jcap
  full = rasterize_with_tiles(pts, f, mapping, size, config)
  out = rasterize_with_tiles(pts, f, mapping, size, config, visit_chunks=visit,
                             visit_capacity=cap)
  assert not bool(out.bin_overflow)
  torch.testing.assert_close(out.image, full.image, rtol=0, atol=1e-12)


def test_truncated_matches_full_and_jax():
  """Image, weight, the gradients wrt points and features, the heuristics
  and the sink visibility of the truncated render against the port's
  untruncated render and JAX's truncated render."""
  points, depth, feats = opaque_pile(31)
  config = RasterConfig(compute_point_heuristic=True, **CFG)
  pts, mapping = port_frame(points, depth, config)
  f = scenes.to_torch(feats)
  visit, cap = probe_visit_chunks(pts, mapping, config, margin_chunks=0)

  def render(visit_args):
    return lambda p, ff, hs, vs: rasterize_with_tiles(
        p, ff, mapping, SIZE, config, heuristic_sink=hs, visibility_sink=vs,
        **visit_args)

  full, g_full = sink_grads(render({}), pts, f)
  tr, g_tr = sink_grads(render(dict(visit_chunks=visit, visit_capacity=cap)),
                        pts, f)
  assert full.bin_overflow is None
  assert tr.bin_overflow.dtype == torch.bool and not bool(tr.bin_overflow)
  torch.testing.assert_close(tr.image, full.image, rtol=0, atol=1e-12)
  torch.testing.assert_close(tr.image_weight, full.image_weight, rtol=0, atol=1e-12)
  for a, b in zip(g_tr, g_full):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
  assert (g_tr[2] > 0).any() and (g_tr[3] > 0).any()   # heuristics, visibility

  jcfg = JaxRasterConfig(compute_point_heuristic=True, **CFG)
  jpts, jmap = jax_frame(points, depth, jcfg)
  jvisit, jcap = jax_function.probe_visit_chunks(
      jpts, jmap, jcfg.replace(compute_point_heuristic=False), margin_chunks=0)
  jf = jnp.asarray(feats)

  def jax_loss(p, ff, hs, vs):
    out = jax_function.rasterize_with_tiles(
        p, ff, jmap, SIZE, jcfg, heuristic_sink=hs, visibility_sink=vs,
        visit_chunks=jvisit, visit_capacity=jcap)
    return jnp.sum(out.image ** 2) + jnp.sum(out.image_weight)

  jout = jax_function.rasterize_with_tiles(jpts, jf, jmap, SIZE, jcfg,
                                           visit_chunks=jvisit,
                                           visit_capacity=jcap)
  jg = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
      jpts, jf, jnp.zeros((N, 2)), jnp.zeros((N,)))
  np.testing.assert_allclose(tr.image.detach().numpy(), np.asarray(jout.image),
                             rtol=0, atol=1e-8)
  np.testing.assert_allclose(tr.image_weight.detach().numpy(),
                             np.asarray(jout.image_weight), rtol=0, atol=1e-8)
  for a, b in zip(g_tr, jg):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=1e-9)


def test_forward_visibility_survives_truncation():
  points, depth, feats = opaque_pile(61)
  config = RasterConfig(compute_visibility=True, **CFG)
  pts, mapping = port_frame(points, depth, config)
  f = scenes.to_torch(feats)
  visit, cap = probe_visit_chunks(pts, mapping, config, margin_chunks=0)
  assert cap < mapping.overlap_to_point.shape[0]
  full = rasterize_with_tiles(pts, f, mapping, SIZE, config)
  tr = rasterize_with_tiles(pts, f, mapping, SIZE, config, visit_chunks=visit,
                            visit_capacity=cap)
  assert not bool(tr.bin_overflow)
  np.testing.assert_allclose(tr.visibility.numpy(), full.visibility.numpy(),
                             rtol=1e-12, atol=1e-14)
  jcfg = JaxRasterConfig(compute_visibility=True, **CFG)
  jpts, jmap = jax_frame(points, depth, jcfg)
  jvisit, jcap = jax_function.probe_visit_chunks(
      jpts, jmap, jcfg.replace(compute_visibility=False), margin_chunks=0)
  jtr = jax_function.rasterize_with_tiles(jpts, jnp.asarray(feats), jmap, SIZE,
                                          jcfg, visit_chunks=jvisit,
                                          visit_capacity=jcap)
  np.testing.assert_allclose(tr.visibility.numpy(), np.asarray(jtr.visibility),
                             rtol=0, atol=1e-8)


def test_undersized_visits_flag_like_jax():
  """Keeping one chunk a tile of a scene that never saturates crops every
  tile with more: both packages flag it."""
  points, depth, feats = scenes.points2d(41, 120, (32, 32))
  config = RasterConfig(tile_size=16, points_per_chunk=8)
  pts, mapping = port_frame(points, depth, config, (32, 32))
  n_tiles = mapping.tile_ranges.shape[0]
  visit = torch.ones(n_tiles, dtype=torch.int32)
  out = rasterize_with_tiles(pts, scenes.to_torch(feats), mapping, (32, 32),
                             config, visit_chunks=visit, visit_capacity=n_tiles * 8)
  assert bool(out.bin_overflow)
  jcfg = JaxRasterConfig(tile_size=16, points_per_chunk=8)
  jpts, jmap = jax_frame(points, depth, jcfg, (32, 32))
  jout = jax_function.rasterize_with_tiles(
      jpts, jnp.asarray(feats), jmap, (32, 32), jcfg,
      visit_chunks=jnp.ones((n_tiles,), jnp.int32), visit_capacity=n_tiles * 8)
  assert bool(jout.bin_overflow)


def test_capacity_drift_flags_like_jax():
  """A visit_capacity one chunk short of the probed fronts crops the last
  run in tile order and flags, though every kept tile saturates."""
  points, depth, feats = opaque_pile(51)
  config = RasterConfig(**CFG)
  pts, mapping = port_frame(points, depth, config)
  visit, cap = probe_visit_chunks(pts, mapping, config, margin_chunks=0)
  g = config.points_per_chunk
  assert cap > g
  out = rasterize_with_tiles(pts, scenes.to_torch(feats), mapping, SIZE, config,
                             visit_chunks=visit, visit_capacity=cap - g)
  assert bool(out.bin_overflow)
  jcfg = JaxRasterConfig(**CFG)
  jpts, jmap = jax_frame(points, depth, jcfg)
  jvisit, jcap = jax_function.probe_visit_chunks(jpts, jmap, jcfg, margin_chunks=0)
  jout = jax_function.rasterize_with_tiles(
      jpts, jnp.asarray(feats), jmap, SIZE, jcfg, visit_chunks=jvisit,
      visit_capacity=jcap - g)
  assert bool(jout.bin_overflow)


def test_truncate_mapping_keeps_each_tiles_prefix():
  """truncate_mapping against a loop over the tiles: each tile keeps
  [start, min(end, (start // g + keep) * g)) of its bin, the kept runs
  abut in tile order, and point_offsets count the kept slots."""
  points, depth, _ = opaque_pile(31)
  config = RasterConfig(**CFG)
  _, mapping = port_frame(points, depth, config)
  g = config.points_per_chunk
  rng = np.random.default_rng(0)
  visit = torch.as_tensor(rng.integers(0, 4, size=mapping.tile_ranges.shape[0]),
                          dtype=torch.int32)
  tr, truncated, drift = truncate_mapping(mapping, visit, None, g)
  assert not bool(drift)
  want, pos = [], 0
  for t, (start, end) in enumerate(mapping.tile_ranges.tolist()):
    keep = min(end, (start // g + int(visit[t])) * g) - start if end > start else 0
    keep = max(keep, 0)
    assert tr.tile_ranges[t].tolist() == [pos, pos + keep]
    assert bool(truncated[t]) == (keep < end - start)
    want += mapping.overlap_to_point[start:start + keep].tolist()
    pos += keep
  assert tr.overlap_to_point.tolist() == want
  assert int(tr.total_overlaps) == pos
  counts = np.bincount(np.asarray(want, np.int64), minlength=N)[:N]
  np.testing.assert_array_equal(tr.point_offsets.numpy(),
                                np.concatenate([[0], np.cumsum(counts)]))


def test_truncation_guard_drifting_training_run():
  """The JAX package's drifting run: descending toward the same scene
  faded to alpha 0.45 lowers every alpha, so tiles saturate later and the
  fronts probed at the start go stale. The guard reprobes at least once,
  every step it hands over equals the untruncated step (loss atol 1e-12,
  gradients rtol 1e-12), and the loss falls below half its start."""
  points0, depth, feats = opaque_pile(41)
  config = RasterConfig(**CFG)
  f, d = scenes.to_torch(feats), scenes.to_torch(depth)
  faded = points0.copy()
  faded[:, 6] = 0.45
  target = rasterize_with_tiles(
      scenes.to_torch(faded), f, map_to_tiles(scenes.to_torch(points0), d, SIZE,
                                              config), SIZE, config).image

  def loss_and_grad(pts, mapping, **visit_args):
    p = pts.clone().requires_grad_()
    out = rasterize_with_tiles(p, f, mapping, SIZE, config, **visit_args)
    loss = ((out.image - target) ** 2).mean()
    return (loss.detach(), torch.autograd.grad(loss, p)[0]), out.bin_overflow

  guard = TruncationGuard(config, margin_chunks=0)
  points = scenes.to_torch(points0)
  losses = []
  for step in range(25):
    mapping = map_to_tiles(points, d, SIZE, config)
    loss, grad = guard.render(points, mapping, lambda vc, cap: loss_and_grad(
        points, mapping, visit_chunks=vc, visit_capacity=cap))
    (loss_full, grad_full), _ = loss_and_grad(points, mapping)
    torch.testing.assert_close(loss, loss_full, rtol=0, atol=1e-12,
                               msg=f"cropped loss at step {step}")
    np.testing.assert_allclose(grad.numpy(), grad_full.numpy(), rtol=1e-12,
                               atol=1e-14)
    losses.append(float(loss))
    points = points - 40.0 * grad
    points[:, 6] = points[:, 6].clamp(0.05, 0.99)
  assert guard.reprobes >= 1, losses
  assert losses[-1] < 0.5 * losses[0], losses


@pytest.mark.parametrize("margin", [0, 1000])
def test_guard_keeps_a_static_frame_without_reprobing(margin):
  """On a static frame the guard never reprobes, whatever the margin: with
  a margin past every front it keeps whole bins, whose chunks (counted
  twice where two bins share one) add up to more than the mapping's K
  slots, and its capacity must allow for that."""
  points, depth, feats = opaque_pile(31)
  config = RasterConfig(**CFG)
  pts, mapping = port_frame(points, depth, config)
  f = scenes.to_torch(feats)
  guard = TruncationGuard(config, margin_chunks=margin)

  def frame(visit_chunks, visit_capacity):
    out = rasterize_with_tiles(pts, f, mapping, SIZE, config,
                               visit_chunks=visit_chunks,
                               visit_capacity=visit_capacity)
    return out, out.bin_overflow

  full = rasterize_with_tiles(pts, f, mapping, SIZE, config)
  for _ in range(2):
    out = guard.render(pts, mapping, frame)
    torch.testing.assert_close(out.image, full.image, rtol=0, atol=1e-12)
  assert guard.reprobes == 0
  if margin:
    assert guard.visit_capacity > mapping.overlap_to_point.shape[0]


def test_guard_raises_when_a_fresh_probe_still_crops():
  points, depth, _ = opaque_pile(31)
  config = RasterConfig(**CFG)
  pts, mapping = port_frame(points, depth, config)
  guard = TruncationGuard(config, margin_chunks=0)
  with pytest.raises(RuntimeError, match="fresh probe"):
    guard.render(pts, mapping, lambda vc, cap: (None, torch.tensor(True)))
  assert guard.reprobes == 1


@pytest.mark.parametrize("field", ["use_alpha_blending", "saturation_early_exit"])
def test_truncation_needs_blending_and_early_exit(field):
  """Truncation is exact only where the saturation early exit is: the
  probe, the render and the guard raise ValueError, as in JAX."""
  points, depth, feats = opaque_pile(31)
  config = RasterConfig(**CFG).replace(**{field: False})
  pts, mapping = port_frame(points, depth, config)
  visit = torch.ones(mapping.tile_ranges.shape[0], dtype=torch.int32)
  with pytest.raises(ValueError, match="saturation_early_exit"):
    probe_visit_chunks(pts, mapping, config)
  with pytest.raises(ValueError, match="saturation_early_exit"):
    rasterize_with_tiles(pts, scenes.to_torch(feats), mapping, SIZE, config,
                         visit_chunks=visit, visit_capacity=8 * len(visit))
  with pytest.raises(ValueError, match="saturation_early_exit"):
    TruncationGuard(config)
