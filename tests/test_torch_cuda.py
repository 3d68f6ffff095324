"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without an NVIDIA GPU.

This file imports no JAX, so it also runs where JAX is not installed. The
repository's conftest.py imports JAX; on such a machine skip it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance (float32, the same inputs through both): p99.9 |diff| <= 1e-4,
and max |diff| <= 2e-2 when blending. The two sides round the pdf and
the transmittance product differently (fused multiply-adds in the kernel,
a scan in torch.cumprod), so a pixel whose alpha lies within rounding of
alpha_threshold can be gated differently: in blending mode that moves
the pixel by at most alpha_threshold times a feature, in quantile mode
it can select another point outright, so only the p99.9 bound holds
there.

Backward kernel against its plain version, slot row by slot row (float32,
the same forward outputs and cotangents through both): per row, p99.9
|diff| <= 1e-4 and max |diff| <= 1e-2 relative to the row's largest
|plain| value. The two add the per-slot sums over pixels and the running
sum C in different orders, and E - C cancels where a pixel's remaining
weight is small. Segment sums: rtol 1e-5 (sums of a few slots, added in
another order).
"""

import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
    backward, forward, rasterize_with_tiles, reduce, reduce_slots_by_point,
    tiles)

import torch_port_scenes as scenes


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _scene(device, n, size, n_features, seed=30):
  points, depth, feats = scenes.points2d(seed, n, size, sigma_range=(0.8, 8.0),
                                         alpha_range=(0.3, 0.99),
                                         n_features=n_features)
  return tuple(scenes.to_torch(x, np.float32).to(device)
               for x in (points, depth, feats))


def _kernel_vs_plain(device, config, n=2000, size=(200, 120), n_features=3):
  pts, depth, f = _scene(device, n, size, n_features)
  mapping = map_to_tiles(pts, depth, size, config)
  before = forward.RASTER_FORWARD.launch_count
  image, weight = forward.rasterize_forward(pts, f, mapping, size, config)
  torch.cuda.synchronize()
  assert forward.RASTER_FORWARD.launch_count == before + 1
  tiled, tiled_w = forward.rasterize_tiles_plain(pts, f, mapping, config)
  want = tiles.tiles_to_image(
      torch.cat([tiled, tiled_w[:, None]], 1), mapping.tile_shape,
      config.tile_size, size)
  got = torch.cat([image, weight[..., None]], -1)
  assert got.shape == (size[1], size[0], n_features + 1)
  return (got - want).abs().flatten().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("blending", [True, False])
@pytest.mark.parametrize("tile_size", [8, 16])
def test_kernel_matches_plain_on_card(cuda_device, antialias, blending, tile_size):
  diff = _kernel_vs_plain(cuda_device, RasterConfig(
      tile_size=tile_size, antialias=antialias, use_alpha_blending=blending))
  assert np.quantile(diff, 0.999) <= 1e-4
  if blending:
    assert diff.max() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_kernel_takes_sixteen_features(cuda_device, tile_size):
  """F = 16 at 32x32 tiles needs more than 48 KB of shared memory."""
  diff = _kernel_vs_plain(cuda_device, RasterConfig(tile_size=tile_size),
                          n_features=forward.MAX_FEATURES)
  assert np.quantile(diff, 0.999) <= 1e-4 and diff.max() <= 2e-2


@pytest.mark.cuda
def test_mapper_on_card_matches_cpu(cuda_device):
  config = RasterConfig(tile_size=16)
  pts, depth, _ = _scene(cuda_device, 3000, (300, 200), 3)
  got = map_to_tiles(pts, depth, (300, 200), config)
  want = map_to_tiles(pts.cpu(), depth.cpu(), (300, 200), config)
  for name in ("overlap_to_point", "overlap_to_tile", "tile_ranges",
               "total_overlaps", "overflow"):
    torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name),
                               rtol=0, atol=0, msg=name)


def _backward_inputs(device, config, n=2000, size=(200, 120), n_features=3,
                     seed=30):
  """A scene, its mapping, the kernel's forward outputs and seeded
  cotangents, all float32 on the card."""
  pts, depth, f = _scene(device, n, size, n_features, seed)
  mapping = map_to_tiles(pts, depth, size, config)
  image, weight = forward.rasterize_forward(pts, f, mapping, size, config)
  rng = np.random.default_rng(seed + 1)
  g_img = torch.tensor(rng.normal(size=tuple(image.shape)), dtype=torch.float32,
                       device=device)
  g_w = torch.tensor(rng.normal(size=tuple(weight.shape)), dtype=torch.float32,
                     device=device)
  return pts, f, mapping, image, weight, g_img, g_w


def assert_rows_close(got, want):
  """Per row: p99.9 |diff| <= 1e-4 and max |diff| <= 1e-2, relative to
  the row's largest |want|."""
  scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
  rel = ((got - want).abs() / scale).cpu().numpy()
  assert np.quantile(rel, 0.999, axis=1).max() <= 1e-4, np.quantile(rel, 0.999, axis=1)
  assert rel.max(axis=1).max() <= 1e-2, rel.max(axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("vis_row", [False, True])
@pytest.mark.parametrize("tile_size", [8, 16])
def test_backward_kernel_matches_plain_on_card(cuda_device, antialias, heuristic,
                                               vis_row, tile_size):
  config = RasterConfig(tile_size=tile_size, antialias=antialias)
  args = _backward_inputs(cuda_device, config)
  before = backward.RASTER_BACKWARD.launch_count
  got = backward.rasterize_backward(*args[:3], config, *args[3:],
                                    compute_point_heuristic=heuristic,
                                    vis_row=vis_row)
  torch.cuda.synchronize()
  assert backward.RASTER_BACKWARD.launch_count == before + 1
  want = backward.raster_backward_plain(*args[:3], config, *args[3:],
                                        compute_point_heuristic=heuristic,
                                        vis_row=vis_row)
  assert got.shape == want.shape == (
      backward.live_grad_rows(3, heuristic, vis_row, antialias),
      args[2].overlap_to_point.shape[0])
  assert want.abs().amax(dim=1).min() > 0
  assert_rows_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_backward_kernel_takes_sixteen_features(cuda_device, tile_size):
  """F = 16 at 32x32 tiles needs more than 48 KB of shared memory."""
  config = RasterConfig(tile_size=tile_size)
  args = _backward_inputs(cuda_device, config, n_features=forward.MAX_FEATURES)
  kw = dict(compute_point_heuristic=True, vis_row=True)
  got = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  want = backward.raster_backward_plain(*args[:3], config, *args[3:], **kw)
  assert_rows_close(got, want)


@pytest.mark.cuda
def test_backward_is_deterministic(cuda_device):
  """No atomics: two backward passes and two reductions are bitwise equal."""
  config = RasterConfig(tile_size=16)
  args = _backward_inputs(cuda_device, config, n=5000, size=(320, 240))
  kw = dict(compute_point_heuristic=True, vis_row=True)
  a = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  b = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  assert torch.equal(a, b)
  assert torch.equal(reduce_slots_by_point(a, args[2]),
                     reduce_slots_by_point(b, args[2]))


@pytest.mark.cuda
def test_segment_sum_kernel_matches_plain(cuda_device):
  """Empty segments, sentinel keys and N not a multiple of 128."""
  rng = np.random.default_rng(7)
  n, k = 1000, 6000
  counts = rng.poisson(3.0, size=n)
  counts[rng.choice(n, 100, replace=False)] = 0
  keys = np.concatenate([np.repeat(np.arange(n), counts),
                         np.full(k - counts.sum(), n)]).astype(np.int32)
  offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
  values = rng.normal(size=(5, k)).astype(np.float32)
  keys_t, off_t, val_t = (torch.tensor(x, device=cuda_device)
                          for x in (keys, offsets, values))
  before = reduce.SEGMENT_SUM.launch_count
  got = reduce.segment_sums_by_sorted_key(keys_t, val_t, off_t, n)
  torch.cuda.synchronize()
  assert reduce.SEGMENT_SUM.launch_count == before + 1
  want = reduce.segment_sums_plain(keys_t, val_t, n)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
  assert (got[:, counts == 0] == 0).all()


@pytest.mark.cuda
def test_training_gradients_match_plain_autograd_on_card(cuda_device):
  """The autograd Function (kernels 1-3 and the chain) against autograd
  through the plain forward on the card: relative L2 <= 1e-3."""
  config = RasterConfig(tile_size=16)
  size = (200, 120)
  pts, depth, f = _scene(cuda_device, 2000, size, 3)
  mapping = map_to_tiles(pts, depth, size, config)
  rng = np.random.default_rng(5)
  g_img = torch.tensor(rng.normal(size=(size[1], size[0], 3)),
                       dtype=torch.float32, device=cuda_device)
  g_w = torch.tensor(rng.normal(size=(size[1], size[0])), dtype=torch.float32,
                     device=cuda_device)

  def grads(render):
    p, ff = pts.clone().requires_grad_(), f.clone().requires_grad_()
    image, weight = render(p, ff)
    return torch.autograd.grad((image * g_img).sum() + (weight * g_w).sum(),
                               [p, ff])

  def kernels(p, ff):
    out = rasterize_with_tiles(p, ff, mapping, size, config)
    return out.image, out.image_weight

  def plain(p, ff):
    image, weight = forward.rasterize_tiles_plain(p, ff, mapping, config)
    return (tiles.tiles_to_image(image, mapping.tile_shape, 16, size),
            tiles.tiles_to_image(weight[:, None], mapping.tile_shape, 16, size)[..., 0])

  counts = [k.launch_count for k in (forward.RASTER_FORWARD,
                                     backward.RASTER_BACKWARD,
                                     reduce.SEGMENT_SUM)]
  got = grads(kernels)
  assert [k.launch_count for k in (forward.RASTER_FORWARD,
                                   backward.RASTER_BACKWARD,
                                   reduce.SEGMENT_SUM)] == [c + 1 for c in counts]
  for a, b in zip(got, grads(plain)):
    assert float((a - b).norm() / b.norm()) <= 1e-3


@pytest.mark.cuda
def test_kernel_raises_on_float64_and_backward(cuda_device):
  """float64 on the card raises in the forward and the backward kernel's
  wrapper; in float32 the backward runs through the kernels."""
  pts, depth, f = (x.double() for x in _scene(cuda_device, 50, (32, 24), 3, 31))
  config = RasterConfig(tile_size=8)
  mapping = map_to_tiles(pts, depth, (32, 24), config)
  with pytest.raises(TypeError, match="float32"):
    forward.rasterize_forward(pts, f, mapping, (32, 24), config)
  ones = torch.ones(24, 32, 3, dtype=torch.float64, device=cuda_device)
  with pytest.raises(TypeError, match="float32"):
    backward.rasterize_backward(pts, f, mapping, config, ones, ones[..., 0],
                                ones, ones[..., 0])
  pts32 = pts.float().requires_grad_()
  out = rasterize_with_tiles(pts32, f.float(), mapping, (32, 24), config)
  before = backward.RASTER_BACKWARD.launch_count
  out.image.sum().backward()
  assert backward.RASTER_BACKWARD.launch_count == before + 1
  assert torch.isfinite(pts32.grad).all() and pts32.grad.abs().sum() > 0
