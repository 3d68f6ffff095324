"""Perspective projection of 3D gaussians to screen space (port of
`taichi_gaussian_rasterizer_tpu.ops.projection`).

Plain torch, differentiable through autograd: gradients reach the four
gaussian tensors, `T_camera_world` and the intrinsics. Same mask-culling
semantics as the JAX package, so outputs line up row for row: all N
points are returned with an `in_view` mask, and culled rows have alpha = 0
and depth = 0, which makes them no-ops in the mapper and rasterizer. The
cull decision is computed on detached values (the JAX package's
`stop_gradient`), which keeps the nan-prone cutoff math out of the
backward graph.

Left out until a caller needs them: `CameraParams.T_image_camera`,
`T_image_world`, `transformed`, `scale_image` and `astype` (use `to`).
"""

from dataclasses import dataclass, replace
from typing import Tuple

import torch

from ..config import RasterConfig
from ..data_types import Gaussians3D
from ..utils import tracing
from . import lib


@dataclass(frozen=True)
class CameraParams:
  """Pinhole camera."""
  projection: torch.Tensor       # (4,) [fx, fy, cx, cy]
  T_camera_world: torch.Tensor   # (4, 4) world -> camera
  near_plane: float
  far_plane: float
  image_size: Tuple[int, int]    # (width, height)

  def __post_init__(self):
    if len(self.image_size) != 2:
      raise ValueError(f"image_size must be (width, height), got {self.image_size}")
    if not (0 < self.near_plane < self.far_plane):
      raise ValueError(
          f"need 0 < near < far, got {self.near_plane}, {self.far_plane}")

  @property
  def depth_range(self):
    return (self.near_plane, self.far_plane)

  @property
  def device(self):
    return self.projection.device

  @property
  def dtype(self):
    return self.projection.dtype

  @property
  def focal_length(self):
    return self.projection[0:2]

  @property
  def principal_point(self):
    return self.projection[2:4]

  @property
  def camera_position(self):
    """Camera origin in world coordinates, -R^T t of the rigid transform."""
    R, t = lib.split_rt(self.T_camera_world)
    return -torch.stack(
        [R[0, i] * t[0] + R[1, i] * t[1] + R[2, i] * t[2] for i in range(3)])

  def to(self, *args, **kwargs) -> "CameraParams":
    return replace(self, projection=self.projection.to(*args, **kwargs),
                   T_camera_world=self.T_camera_world.to(*args, **kwargs))


def project_points(
    position: torch.Tensor,        # (N, 3)
    log_scaling: torch.Tensor,     # (N, 3)
    rotation: torch.Tensor,        # (N, 4)
    alpha_logit: torch.Tensor,     # (N, 1)
    T_camera_world: torch.Tensor,  # (4, 4) or (3, 4)
    projection: torch.Tensor,      # (4,)
    image_size: Tuple[int, int],
    depth_range: Tuple[float, float],
    blur_cov: float = 0.3,
    clamp_margin: float = 0.15,
    alpha_threshold: float = 1.0 / 255.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Project all N gaussians (EWA approximation).

  Returns:
    points: (N, 7) packed 2D gaussians [mean, axis, sigma, alpha];
      culled rows are 0
    depth:  (N, 1) camera-space z; culled rows are 0
    in_view: (N,) bool visibility mask
  """
  dtype = position.dtype
  T = T_camera_world.to(dtype)
  fx, fy, cx, cy = (projection.to(dtype)[i] for i in range(4))
  w_size, h_size = image_size

  pxw, pyw, pzw = position[:, 0], position[:, 1], position[:, 2]

  # normalized quaternion -> rotation matrix components
  qx, qy, qz, qw = (rotation[:, i] for i in range(4))
  qn = torch.sqrt(torch.clamp(qx * qx + qy * qy + qz * qz + qw * qw, min=1e-32))
  qx, qy, qz, qw = qx / qn, qy / qn, qz / qn, qw / qn
  xx, yy, zz = qx * qx, qy * qy, qz * qz
  R = ((1 - 2 * yy - 2 * zz, 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)),
       (2 * (qx * qy + qw * qz), 1 - 2 * xx - 2 * zz, 2 * (qy * qz - qw * qx)),
       (2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * xx - 2 * yy))
  s = (torch.exp(log_scaling[:, 0]), torch.exp(log_scaling[:, 1]),
       torch.exp(log_scaling[:, 2]))

  # camera transform + pinhole projection
  in_cam = [pxw * T[i, 0] + pyw * T[i, 1] + pzw * T[i, 2] + T[i, 3]
            for i in range(3)]
  z = in_cam[2]
  inv_z = 1.0 / z
  mx = fx * in_cam[0] * inv_z + cx
  my = fy * in_cam[1] * inv_z + cy

  # position-clamped affine Jacobian rows:
  # J = [[fx/z, 0, -(tx-cx)/z], [0, fy/z, -(ty-cy)/z]]
  tx = torch.clamp(mx, -w_size * clamp_margin, (w_size - 1) * (1 + clamp_margin))
  ty = torch.clamp(my, -h_size * clamp_margin, (h_size - 1) * (1 + clamp_margin))
  j00 = fx * inv_z
  j11 = fy * inv_z
  j02 = -(tx - cx) * inv_z
  j12 = -(ty - cy) * inv_z

  # EWA: m = J W (R S); cov = m m^T upper-triangular
  jw0 = [j00 * T[0, k] + j02 * T[2, k] for k in range(3)]
  jw1 = [j11 * T[1, k] + j12 * T[2, k] for k in range(3)]
  m0 = [(jw0[0] * R[0][l] + jw0[1] * R[1][l] + jw0[2] * R[2][l]) * s[l]
        for l in range(3)]
  m1 = [(jw1[0] * R[0][l] + jw1[1] * R[1][l] + jw1[2] * R[2][l]) * s[l]
        for l in range(3)]
  cov_a = m0[0] * m0[0] + m0[1] * m0[1] + m0[2] * m0[2] + blur_cov
  cov_b = m0[0] * m1[0] + m0[1] * m1[1] + m0[2] * m1[2]
  cov_c = m1[0] * m1[0] + m1[1] * m1[1] + m1[2] * m1[2] + blur_cov

  # closed-form 2x2 symmetric eigendecomposition; of the two equivalent
  # eigenvector candidates take the larger (avoids 0/0 when cov_b -> 0)
  tr = cov_a + cov_c
  det = cov_a * cov_c - cov_b * cov_b
  gap_floor = 1e-12 * tr * tr + 1e-36
  sqrt_gap = torch.sqrt(torch.maximum(tr * tr - 4 * det, gap_floor))
  lam1 = (tr + sqrt_gap) * 0.5
  lam2 = (tr - sqrt_gap) * 0.5
  c1x, c1y = cov_a - lam2, cov_b
  c2x, c2y = cov_b, cov_c - lam2
  n1 = c1x * c1x + c1y * c1y
  n2 = c2x * c2x + c2y * c2y
  pick1 = n1 >= n2
  vx = torch.where(pick1, c1x, c2x)
  vy = torch.where(pick1, c1y, c2y)
  iso = (n1 + n2) < 1e-30
  vx = torch.where(iso, torch.ones_like(vx), vx)
  vy = torch.where(iso, torch.zeros_like(vy), vy)
  vn = torch.sqrt(torch.clamp(vx * vx + vy * vy, min=1e-32))
  ax = vx / vn
  ay = vy / vn
  sig1 = torch.sqrt(torch.clamp(lam1, min=0.0))
  sig2 = torch.sqrt(torch.clamp(lam2, min=0.0))

  alpha = lib.sigmoid(alpha_logit[:, 0])

  # the cull decision is non-differentiable
  alpha_c = alpha.detach()
  gs = lib.gaussian_scale_factor(alpha_c, alpha_threshold)
  r0 = sig1.detach() * gs
  r1 = sig2.detach() * gs
  ax_c, ay_c = ax.detach(), ay.detach()
  ext_x = torch.sqrt((ax_c * r0) ** 2 + (ay_c * r1) ** 2)
  ext_y = torch.sqrt((ay_c * r0) ** 2 + (ax_c * r1) ** 2)
  mx_c, my_c, z_c = mx.detach(), my.detach(), z.detach()

  near, far = depth_range
  in_view = ((z_c > near) & (z_c < far)
             & (mx_c + ext_x > 0) & (my_c + ext_y > 0)
             & (mx_c - ext_x < w_size) & (my_c - ext_y < h_size)
             & (alpha_c > alpha_threshold))

  keepf = in_view.to(dtype)
  points = torch.stack(
      [mx * keepf, my * keepf, ax * keepf, ay * keepf,
       sig1 * keepf, sig2 * keepf, alpha * keepf], dim=-1)
  depth = (z * keepf)[:, None]
  return points, depth, in_view


def project_to_image(
    gaussians: Gaussians3D, camera_params: CameraParams,
    config: RasterConfig = RasterConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Project 3D gaussians to packed 2D gaussians.

  Returns (points (N, 7), depth (N, 1), in_view (N,) bool mask).
  """
  with tracing.span("project"):
    return project_points(
        *gaussians.shape_tensors(),
        camera_params.T_camera_world,
        camera_params.projection,
        camera_params.image_size,
        camera_params.depth_range,
        blur_cov=config.blur_cov,
        clamp_margin=config.clamp_margin,
        alpha_threshold=config.alpha_threshold)
