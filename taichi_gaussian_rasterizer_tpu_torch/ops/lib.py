"""Math helpers (port of the parts of `taichi_gaussian_rasterizer_tpu.ops.lib`
that the render paths and the 2D trainer call).

Left out for now: the 2x2 eigendecomposition and pdf helpers (projection
inlines its own columnized eigendecomposition, the rasterizer its pdfs),
the quaternion algebra beyond `quat_to_mat`, and the EWA helpers. They
come with their users in later slices.
"""

import torch


def sigmoid(x):
  return torch.sigmoid(x)


def inverse_sigmoid(x):
  return -torch.log(1.0 / x - 1.0)


def perp(v):
  """90-degree rotation of a 2D vector."""
  return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def dot(a, b):
  return torch.sum(a * b, dim=-1)


def safe_normalize(v, eps=1e-32):
  """Normalize along the last axis; zero (with a nan-free gradient) at v == 0."""
  sq = torch.sum(v * v, dim=-1, keepdim=True)
  ok = sq > eps
  sq = torch.where(ok, sq, torch.ones_like(sq))
  return torch.where(ok, v / torch.sqrt(sq), torch.zeros_like(v))


def quat_to_mat(q):
  """(..., 4) xyzw -> (..., 3, 3) rotation matrix."""
  x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  x2, y2, z2 = x * x, y * y, z * z
  rows = [
      [1 - 2 * y2 - 2 * z2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
      [2 * x * y + 2 * w * z, 1 - 2 * x2 - 2 * z2, 2 * y * z - 2 * w * x],
      [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x2 - 2 * y2],
  ]
  return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def join_rt(r, t):
  """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) transform."""
  top = torch.cat([r, t[..., :, None]], dim=-1)
  bottom = torch.tensor([0, 0, 0, 1], dtype=top.dtype, device=top.device)
  bottom = bottom.expand(top.shape[:-2] + (1, 4))
  return torch.cat([top, bottom], dim=-2)


def split_rt(rt):
  return rt[..., :3, :3], rt[..., :3, 3]


def gaussian_scale_factor(alpha, alpha_threshold):
  """Adaptive cutoff radius factor sqrt(2 ln(alpha/threshold)), zero for
  alpha <= threshold."""
  ratio = torch.clamp(alpha / alpha_threshold, min=1.0)
  return torch.sqrt(2.0 * torch.log(ratio))


def ndc_depth(depth, near, far):
  """NDC depth in [0 (near), 1 (far)]."""
  return 1.0 - (1.0 / depth - 1.0 / far) / (1.0 / near - 1.0 / far)


def inverse_ndc_depth(ndc, near, far):
  return 1.0 / ((1.0 - ndc) * (1.0 / near - 1.0 / far) + 1.0 / far)


def pack_g2d(mean, axis, sigma, alpha):
  """(..., 2), (..., 2), (..., 2), (...,) -> (..., 7) packed 2D gaussians."""
  return torch.cat([mean, axis, sigma, alpha[..., None]], dim=-1)


def unpack_g2d(vec):
  """(..., 7) -> mean, axis, sigma, alpha."""
  return vec[..., 0:2], vec[..., 2:4], vec[..., 4:6], vec[..., 6]
