"""Random scenes for tests and benchmarks (port of
`taichi_gaussian_rasterizer_tpu.utils.random_data`: `random_camera`,
`random_3d_gaussians`, `trained_like_gaussians` and `random_2d_gaussians`).

Driven by an explicit `torch.Generator`; tensors are made on the
generator's device. The same seed gives different numbers than the JAX
package's `jax.random` keys: tests that compare the two packages make
their scenes with numpy instead.
"""

import math
from typing import Optional, Tuple

import torch

from ..data_types import Gaussians2D, Gaussians3D
from ..ops import lib
from ..ops.projection import CameraParams


def _rand(gen, *shape, dtype):
  return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _randn(gen, *shape, dtype):
  return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def unproject_points(uv, depth, camera: CameraParams):
  """Image uv (..., 2) + depth (..., 1) -> world xyz, through closed-form
  intrinsic and rigid inverses."""
  fx, fy, cx, cy = (camera.projection[i] for i in range(4))
  cam_xyz = torch.cat([(uv[..., 0:1] - cx) * depth / fx,
                       (uv[..., 1:2] - cy) * depth / fy, depth], dim=-1)
  R, t = lib.split_rt(camera.T_camera_world)
  d = cam_xyz - t
  return torch.stack(
      [d[..., 0] * R[0, i] + d[..., 1] * R[1, i] + d[..., 2] * R[2, i]
       for i in range(3)], dim=-1)


def random_camera(generator: torch.Generator, pos_scale: float = 1.0,
                  image_size: Optional[Tuple[int, int]] = None,
                  image_size_range: Tuple[int, int] = (256, 1024),
                  near_plane: float = 0.1,
                  dtype=torch.float32) -> CameraParams:
  """Camera with a random pose, field of view (30-100 degrees) and
  principal point."""
  q = lib.safe_normalize(_randn(generator, 4, dtype=dtype))
  t = _randn(generator, 3, dtype=dtype) * pos_scale
  R = lib.quat_to_mat(q)
  rt_t = torch.stack(
      [R[0, i] * t[0] + R[1, i] * t[1] + R[2, i] * t[2] for i in range(3)])
  T_camera_world = lib.join_rt(R.T, -rt_t)

  if image_size is None:
    lo, hi = image_size_range
    image_size = tuple(int(x) for x in torch.randint(
        lo, hi, (2,), generator=generator, device=generator.device))
  w, h = image_size
  c = (torch.tensor([w / 2, h / 2], dtype=dtype, device=generator.device)
       + _randn(generator, 2, dtype=dtype) * (w / 20))
  fov = torch.deg2rad(_rand(generator, dtype=dtype) * 70 + 30)
  f = w / (2 * torch.tan(fov / 2))

  return CameraParams(
      projection=torch.stack([f, f, c[0], c[1]]),
      T_camera_world=T_camera_world,
      near_plane=near_plane,
      far_plane=near_plane * 1000.0,
      image_size=(w, h))


def random_3d_gaussians(generator: torch.Generator, n: int,
                        camera_params: CameraParams,
                        scale_factor: float = 1.0,
                        alpha_range=(0.1, 0.9), margin: float = 0.0,
                        sh_degree: Optional[int] = None,
                        dtype=torch.float32) -> Gaussians3D:
  """Gaussians placed by unprojecting uniform image uv at uniform NDC
  depth, so most land in the frustum; scale proportional to depth / fx.
  Features are RGB, or degree-`sh_degree` SH coefficients."""
  w, h = camera_params.image_size
  size = torch.tensor([w, h], dtype=dtype, device=generator.device)
  uv = (_rand(generator, n, 2, dtype=dtype) * (1 + margin) - margin * 0.5) * size
  depth = lib.inverse_ndc_depth(_rand(generator, n, dtype=dtype),
                                camera_params.near_plane, camera_params.far_plane)
  position = unproject_points(uv, depth[:, None], camera_params)
  fx = camera_params.projection[0]

  scale = (w / math.sqrt(max(n, 1))) * (depth / fx) * scale_factor
  scaling = (_rand(generator, n, 3, dtype=dtype) + 0.2) * scale[:, None]
  rotation = lib.safe_normalize(_randn(generator, n, 4, dtype=dtype))

  low, high = alpha_range
  alpha = _rand(generator, n, dtype=dtype) * (high - low) + low

  if sh_degree is None:
    feature = _rand(generator, n, 3, dtype=dtype)
  else:
    feature = _rand(generator, n, 3, (sh_degree + 1) ** 2, dtype=dtype) - 0.5

  return Gaussians3D(
      position=position,
      log_scaling=torch.log(scaling),
      rotation=rotation,
      alpha_logit=lib.inverse_sigmoid(alpha)[:, None],
      feature=feature)


def trained_like_gaussians(generator: torch.Generator, n: int,
                           camera_params: CameraParams,
                           surface_frac: float = 0.8,
                           dtype=torch.float32) -> Gaussians3D:
  """A synthetic stand-in for a trained 3DGS checkpoint, with the
  occupancy that drives the rasterizer's cost on trained scenes (the JAX
  package's recipe, drawn from the generator):

  * 60% of the points in 48 clusters (spread 4% of the image), the rest
    uniform over the image, so that tiles hold heavy-tailed point counts;
  * the first `surface_frac` of them at near depths (ndc^1.5 * 0.6 +
    0.05), the rest a background at far depths (0.7 + 0.3 ndc);
  * log-normal sizes (sigma 0.8; surface x1.1, background x3) with
    per-axis anisotropy (log-normal, sigma 0.5);
  * mostly opaque alphas, logit ~ N(1.8, 1.6) (median ~0.86).

  Most pixels of such a frame saturate, as on a trained scene.
  """
  w, h = camera_params.image_size
  device = generator.device
  size = torch.tensor([w, h], dtype=dtype, device=device)
  n_surf = int(n * surface_frac)
  n_clusters = 48
  centers = _rand(generator, n_clusters, 2, dtype=dtype) * size
  cid = torch.randint(0, n_clusters, (n,), generator=generator, device=device)
  uv_cluster = centers[cid] + _randn(generator, n, 2, dtype=dtype) * (size * 0.04)
  uv_uniform = _rand(generator, n, 2, dtype=dtype) * size
  in_cluster = _rand(generator, n, dtype=dtype) < 0.6
  uv = torch.where(in_cluster[:, None], uv_cluster, uv_uniform)
  uv = torch.minimum(torch.clamp(uv, min=0.0), size - 1.0)

  is_surf = torch.arange(n, device=device) < n_surf
  ndc = _rand(generator, n, dtype=dtype)
  ndc = torch.where(is_surf, ndc ** 1.5 * 0.6 + 0.05, 0.7 + 0.3 * ndc)
  depth = lib.inverse_ndc_depth(ndc, camera_params.near_plane,
                                camera_params.far_plane)
  position = unproject_points(uv, depth[:, None], camera_params)

  fx = camera_params.projection[0]
  base = (w / math.sqrt(max(n, 1))) * (depth / fx)
  size_mult = torch.exp(_randn(generator, n, dtype=dtype) * 0.8 + torch.where(
      is_surf, math.log(1.1), math.log(3.0)))
  aniso = torch.exp(_randn(generator, n, 3, dtype=dtype) * 0.5)
  scaling = base[:, None] * size_mult[:, None] * aniso

  rotation = lib.safe_normalize(_randn(generator, n, 4, dtype=dtype))
  alpha_logit = _randn(generator, n, dtype=dtype) * 1.6 + 1.8
  return Gaussians3D(
      position=position,
      log_scaling=torch.log(scaling),
      rotation=rotation,
      alpha_logit=alpha_logit[:, None],
      feature=_rand(generator, n, 3, dtype=dtype))


def random_2d_gaussians(generator: torch.Generator, n: int,
                        image_size: Tuple[int, int], num_channels: int = 3,
                        scale_factor: float = 1.0, alpha_range=(0.1, 0.9),
                        depth_range=(0.0, 1.0),
                        dtype=torch.float32) -> Gaussians2D:
  """2D gaussians at uniform positions over the image, uniform depths in
  depth_range, scales ~ image width / sqrt(n), random rotations and
  alphas, uniform features."""
  w, h = image_size
  position = _rand(generator, n, 2, dtype=dtype) * torch.tensor(
      [w, h], dtype=dtype, device=generator.device)
  depth = (_rand(generator, n, 1, dtype=dtype)
           * (depth_range[1] - depth_range[0]) + depth_range[0])

  density_scale = scale_factor * w / (1 + math.sqrt(n))
  scaling = (_rand(generator, n, 2, dtype=dtype) + 0.2) * density_scale
  rotation = lib.safe_normalize(_randn(generator, n, 2, dtype=dtype))

  low, high = alpha_range
  alpha = _rand(generator, n, dtype=dtype) * (high - low) + low

  return Gaussians2D(
      position=position,
      z_depth=depth,
      log_scaling=torch.log(scaling),
      rotation=rotation,
      alpha_logit=lib.inverse_sigmoid(alpha)[:, None],
      feature=_rand(generator, n, num_channels, dtype=dtype))
