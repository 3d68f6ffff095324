"""Carry parameters into the port from numpy arrays.

The JAX package's arrays become numpy with `np.asarray`; these helpers
turn them into this package's tensors on a device (the card unless the
caller names another, as the CPU tests do) and dtype, so both packages
can be fed the same scene.
"""

from typing import Tuple

import numpy as np
import torch

from .data_types import Gaussians2D, Gaussians3D
from .ops.projection import CameraParams


def _tensor(x, device, dtype) -> torch.Tensor:
  return torch.as_tensor(np.asarray(x), device=device).to(dtype).contiguous()


def gaussians_from_numpy(position, log_scaling, rotation, alpha_logit,
                         feature, device="cuda",
                         dtype=torch.float32) -> Gaussians3D:
  """numpy arrays (N,3), (N,3), (N,4) xyzw, (N,1), (N,C) or (N,3,K)."""
  return Gaussians3D(
      position=_tensor(position, device, dtype),
      log_scaling=_tensor(log_scaling, device, dtype),
      rotation=_tensor(rotation, device, dtype),
      alpha_logit=_tensor(alpha_logit, device, dtype),
      feature=_tensor(feature, device, dtype))


def gaussians2d_from_numpy(position, z_depth, log_scaling, rotation,
                           alpha_logit, feature, device="cuda",
                           dtype=torch.float32) -> Gaussians2D:
  """numpy arrays (N,2), (N,1), (N,2), (N,2) unit complex, (N,1), (N,C)."""
  return Gaussians2D(
      position=_tensor(position, device, dtype),
      z_depth=_tensor(z_depth, device, dtype),
      log_scaling=_tensor(log_scaling, device, dtype),
      rotation=_tensor(rotation, device, dtype),
      alpha_logit=_tensor(alpha_logit, device, dtype),
      feature=_tensor(feature, device, dtype))


def camera_from_numpy(projection, T_camera_world, near: float, far: float,
                      image_size: Tuple[int, int], device="cuda",
                      dtype=torch.float32) -> CameraParams:
  """projection (4,) [fx, fy, cx, cy]; T_camera_world (4, 4);
  image_size (width, height)."""
  return CameraParams(
      projection=_tensor(projection, device, dtype),
      T_camera_world=_tensor(T_camera_world, device, dtype),
      near_plane=float(near), far_plane=float(far),
      image_size=(int(image_size[0]), int(image_size[1])))
