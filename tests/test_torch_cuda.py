"""The port's CUDA forward kernel against its plain PyTorch version, on the
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
"""

import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
    forward, rasterize_with_tiles, tiles)

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


@pytest.mark.cuda
def test_kernel_raises_on_float64_and_backward(cuda_device):
  pts, depth, f = (x.double() for x in _scene(cuda_device, 50, (32, 24), 3, 31))
  config = RasterConfig(tile_size=8)
  mapping = map_to_tiles(pts, depth, (32, 24), config)
  with pytest.raises(TypeError, match="float32"):
    forward.rasterize_forward(pts, f, mapping, (32, 24), config)
  pts32 = pts.float().requires_grad_()
  out = rasterize_with_tiles(pts32, f.float(), mapping, (32, 24), config)
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    out.image.sum().backward()
