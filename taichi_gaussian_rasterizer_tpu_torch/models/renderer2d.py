"""2D gaussian pipeline: projection, basis helpers, split ops (port of
`taichi_gaussian_rasterizer_tpu.models.renderer2d`).

Plain torch throughout. The split ops draw from an explicit
`torch.Generator` where the JAX code takes a PRNG key; the same seed gives
other numbers than the JAX package's keys, so the tests hold the random
paths to their shapes and the deterministic paths to the JAX values.
"""

import math
from typing import Optional, Tuple

import torch

from ..config import RasterConfig
from ..data_types import Gaussians2D
from ..ops import lib
from ..ops.raster import rasterize


def project_gaussians2d(points: Gaussians2D,
                        image_size: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
  """Pack Gaussians2D into the (N, 7) [mean, axis, sigma, alpha] format.
  Differentiable. `image_size` is accepted for the JAX signature's sake
  and unused (the 2D path culls nothing)."""
  del image_size
  alpha = torch.sigmoid(points.alpha_logit.reshape(-1))
  v1 = lib.safe_normalize(points.rotation)
  return lib.pack_g2d(points.position, v1, points.scaling, alpha)


def point_rotation(points: Gaussians2D) -> torch.Tensor:
  """(N, 2, 2) rotation whose rows are the gaussian's unit axes."""
  v1 = lib.safe_normalize(points.rotation)
  return torch.stack([v1, lib.perp(v1)], dim=1)


def point_basis(points: Gaussians2D, eps: float = 1e-4) -> torch.Tensor:
  """(N, 2, 2) basis whose columns are the scaled axes:
  basis @ e_i = axis_i * scale_i."""
  scale = torch.clamp(points.scaling, min=eps)
  v1 = lib.safe_normalize(points.rotation)
  return torch.stack([v1, lib.perp(v1)], dim=2) * scale[:, None, :]


def point_covariance(points: Gaussians2D) -> torch.Tensor:
  basis = point_basis(points)
  return torch.einsum("nij,nkj->nik", basis, basis)


def split_with_offsets(generator: torch.Generator, points: Gaussians2D,
                       offsets: torch.Tensor,
                       depth_noise: float = 1e-2) -> Gaussians2D:
  """Replicate each gaussian to its (N, n, 2) offset samples and jitter
  the copies' depths."""
  n = offsets.shape[1]
  g = points[torch.arange(points.position.shape[0],
                          device=offsets.device).repeat_interleave(n)]
  noise = torch.randn(g.z_depth.shape, generator=generator,
                      device=g.z_depth.device, dtype=g.z_depth.dtype)
  return g.replace(
      position=g.position + offsets.reshape(-1, 2),
      z_depth=torch.clamp(g.z_depth + noise * depth_noise, min=1e-6))


def _sample_in_basis(points: Gaussians2D, samples: torch.Tensor) -> torch.Tensor:
  """Map (N, n, 2) eigen-frame samples to image-space offsets."""
  return torch.einsum("nij,nsj->nsi", point_basis(points), samples)


def split_gaussians2d(generator: torch.Generator, points: Gaussians2D,
                      n: int = 2, scaling: Optional[float] = None,
                      depth_noise: float = 1e-2) -> Gaussians2D:
  """Random-sample split: each gaussian becomes n copies at
  gaussian-distributed offsets in its own basis, scaled by 1/sqrt(n) by
  default."""
  num = points.position.shape[0]
  samples = 0.5 * torch.randn((num, n, 2), generator=generator,
                              device=points.position.device,
                              dtype=points.position.dtype)
  offsets = _sample_in_basis(points, samples)
  if scaling is None:
    scaling = 1 / math.sqrt(n)
  points = points.replace(log_scaling=points.log_scaling + math.log(scaling))
  return split_with_offsets(generator, points, offsets, depth_noise)


def uniform_split_gaussians2d(generator: torch.Generator, points: Gaussians2D,
                              n: int = 2, scaling: Optional[float] = None,
                              depth_noise: float = 1e-2, sep: float = 0.7,
                              random_axis: bool = False,
                              eps: float = 1e-6) -> Gaussians2D:
  """Split along the dominant axis (or one drawn with probability in
  proportion to its scale) into n copies evenly spaced over +-sep."""
  dtype = points.position.dtype
  if random_axis:
    probs = points.scaling + eps
    probs = probs / probs.sum(dim=1, keepdim=True)
    axis_idx = torch.multinomial(probs, 1, generator=generator)[:, 0]
  else:
    axis_idx = torch.argmax(points.log_scaling, dim=1)

  axis = torch.nn.functional.one_hot(axis_idx, 2).to(dtype)          # (N, 2)
  values = torch.linspace(-sep, sep, n, dtype=dtype,
                          device=points.position.device)
  samples = values[None, :, None] * axis[:, None, :]                  # (N, n, 2)
  offsets = _sample_in_basis(points, samples)

  if scaling is None:
    scaling = math.sqrt(n) / n
  points = points.set_scaling(points.scaling * (axis * scaling + (1 - axis)))
  return split_with_offsets(generator, points, offsets, depth_noise)


def render_gaussians(gaussians: Gaussians2D,
                     image_size: Tuple[int, int],
                     raster_config: RasterConfig = RasterConfig(),
                     **raster_kwargs):
  """Project and rasterize a 2D scene; returns the RasterOut."""
  return rasterize(
      gaussians2d=project_gaussians2d(gaussians),
      depth=torch.clamp(gaussians.z_depth.reshape(-1), 0.0, 1.0),
      features=gaussians.feature,
      image_size=image_size,
      config=raster_config,
      **raster_kwargs)
