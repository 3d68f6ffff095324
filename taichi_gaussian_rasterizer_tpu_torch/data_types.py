"""Gaussian dataclasses (port of `taichi_gaussian_rasterizer_tpu.data_types`).

Plain frozen dataclasses of tensors. Packed 2D gaussian format (produced
by projection, consumed by the tile mapper and rasterizer):

  7 floats = mean(2), axis(2: unit major eigenvector), sigma(2: sqrt of
  eigenvalues), alpha(1)
"""

from dataclasses import dataclass, fields, replace

import torch


def _map(obj, fn):
  return replace(obj, **{f.name: fn(getattr(obj, f.name)) for f in fields(obj)})


def _concat(a, b):
  return replace(a, **{f.name: torch.cat([getattr(a, f.name), getattr(b, f.name)])
                       for f in fields(a)})


@dataclass(frozen=True)
class Gaussians3D:
  """3D gaussians."""
  position: torch.Tensor     # (N, 3) xyz
  log_scaling: torch.Tensor  # (N, 3) scale = exp(log_scaling)
  rotation: torch.Tensor     # (N, 4) quaternion xyzw
  alpha_logit: torch.Tensor  # (N, 1) alpha = sigmoid(alpha_logit)
  feature: torch.Tensor      # (N, C) or (N, 3, (d+1)^2) spherical harmonics

  def __post_init__(self):
    for name, width in (("position", 3), ("log_scaling", 3),
                        ("rotation", 4), ("alpha_logit", 1)):
      v = getattr(self, name)
      if v.shape[-1] != width:
        raise ValueError(f"{name}: expected (..., {width}), got {tuple(v.shape)}")

  def packed(self) -> torch.Tensor:
    """(N, 11) packed layout [position, log_scaling, rotation, alpha_logit]."""
    return torch.cat(
        [self.position, self.log_scaling, self.rotation, self.alpha_logit], dim=-1)

  def shape_tensors(self):
    return (self.position, self.log_scaling, self.rotation, self.alpha_logit)

  @property
  def scale(self):
    return torch.exp(self.log_scaling)

  @property
  def alpha(self):
    return torch.sigmoid(self.alpha_logit)

  @property
  def batch_size(self):
    return self.position.shape[:-1]

  @property
  def device(self):
    return self.position.device

  def replace(self, **kwargs) -> "Gaussians3D":
    return replace(self, **kwargs)

  def concat(self, other: "Gaussians3D") -> "Gaussians3D":
    return _concat(self, other)

  def to(self, *args, **kwargs) -> "Gaussians3D":
    return _map(self, lambda t: t.to(*args, **kwargs))

  def __getitem__(self, idx) -> "Gaussians3D":
    return _map(self, lambda t: t[idx])

  @staticmethod
  def unpack(packed: torch.Tensor, feature: torch.Tensor) -> "Gaussians3D":
    if packed.shape[-1] != 11:
      raise ValueError(f"expected (..., 11), got {tuple(packed.shape)}")
    return Gaussians3D(
        position=packed[..., 0:3], log_scaling=packed[..., 3:6],
        rotation=packed[..., 6:10], alpha_logit=packed[..., 10:11],
        feature=feature)


@dataclass(frozen=True)
class Gaussians2D:
  """2D toy gaussians."""
  position: torch.Tensor     # (N, 2) xy
  z_depth: torch.Tensor      # (N, 1) for sorting
  log_scaling: torch.Tensor  # (N, 2)
  rotation: torch.Tensor     # (N, 2) unit complex number
  alpha_logit: torch.Tensor  # (N, 1)
  feature: torch.Tensor      # (N, C)

  @property
  def opacity(self):
    return torch.sigmoid(self.alpha_logit)

  @property
  def scaling(self):
    return torch.exp(self.log_scaling)

  @property
  def batch_size(self):
    return self.position.shape[:-1]

  def set_scaling(self, scaling) -> "Gaussians2D":
    return replace(self, log_scaling=torch.log(scaling))

  def replace(self, **kwargs) -> "Gaussians2D":
    return replace(self, **kwargs)

  def concat(self, other: "Gaussians2D") -> "Gaussians2D":
    return _concat(self, other)

  def to(self, *args, **kwargs) -> "Gaussians2D":
    return _map(self, lambda t: t.to(*args, **kwargs))

  def __getitem__(self, idx) -> "Gaussians2D":
    return _map(self, lambda t: t[idx])


def check_packed3d(packed: torch.Tensor):
  if packed.ndim != 2 or packed.shape[1] != 11:
    raise ValueError(f"Expected shape (N, 11), got {tuple(packed.shape)}")


def check_packed2d(packed: torch.Tensor):
  if packed.ndim != 2 or packed.shape[1] != 7:
    raise ValueError(f"Expected shape (N, 7), got {tuple(packed.shape)}")
