"""Math helpers (port of `taichi_gaussian_rasterizer_tpu.ops.lib`).

Function for function, batched over leading dimensions, in the inputs'
dtype; gradients come from autograd. Covariances are upper-triangular
(..., 3) vectors (a, b, c) = [[a, b], [b, c]]; quaternions are xyzw.
Left out: the EWA projection helpers (`project_with_jacobian`,
`gaussian_covariance_in_image`, `project_gaussian`) and the antialiased
pdf, which `ops.projection` and the rasterizer inline in their own form.
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


def scaled_quat_to_mat(q, s):
  """R @ diag(s): the rotation with its columns scaled."""
  return quat_to_mat(q) * s[..., None, :]


def quat_mul(q1, q2):
  """Hamilton product, xyzw."""
  x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
  x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
  return torch.stack([
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
  ], dim=-1)


def quat_conj(q):
  return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q, v):
  """v (..., 3) rotated by the unit quaternion q."""
  qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
  return quat_mul(quat_mul(q, qv), quat_conj(q))[..., :3]


def join_rt(r, t):
  """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) transform."""
  top = torch.cat([r, t[..., :, None]], dim=-1)
  bottom = torch.tensor([0, 0, 0, 1], dtype=top.dtype, device=top.device)
  bottom = bottom.expand(top.shape[:-2] + (1, 4))
  return torch.cat([top, bottom], dim=-2)


def split_rt(rt):
  return rt[..., :3, :3], rt[..., :3, 3]


def upper(cov_mat):
  """(..., 2, 2) -> (..., 3) upper triangle."""
  return torch.stack(
      [cov_mat[..., 0, 0], cov_mat[..., 0, 1], cov_mat[..., 1, 1]], dim=-1)


def inverse_cov(cov):
  """Inverse of a symmetric 2x2 in (..., 3) form."""
  a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
  inv_det = 1.0 / (a * c - b * b)
  return torch.stack([inv_det * c, -inv_det * b, inv_det * a], dim=-1)


def eig(cov):
  """Closed-form 2x2 symmetric eigendecomposition: (sigma (..., 2), the
  square roots of the eigenvalues, larger first; v1 (..., 2) the major
  unit eigenvector; v2 = perp(v1)). Of the two equivalent formulas for
  v1 it takes the larger, per element (no 0/0 as b -> 0); the eigenvalue
  gap has a relative floor, so the gradient stays finite at repeated
  eigenvalues."""
  a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
  tr = a + c
  det = a * c - b * b
  gap = torch.maximum(tr * tr - 4 * det, 1e-12 * tr * tr + 1e-36)
  sqrt_gap = torch.sqrt(gap)
  lam1 = (tr + sqrt_gap) * 0.5
  lam2 = (tr - sqrt_gap) * 0.5
  cand1 = torch.stack([a - lam2, b], dim=-1)
  cand2 = torch.stack([b, c - lam2], dim=-1)
  n1 = torch.sum(cand1 * cand1, dim=-1)
  n2 = torch.sum(cand2 * cand2, dim=-1)
  v = torch.where((n1 >= n2)[..., None], cand1, cand2)
  # isotropic (b == 0, a == c): any direction; the x axis
  iso = (n1 + n2) < 1e-30
  v = torch.where(iso[..., None], torch.tensor([1.0, 0.0], dtype=v.dtype,
                                               device=v.device).expand_as(v), v)
  v1 = safe_normalize(v)
  sigma = torch.sqrt(torch.clamp(torch.stack([lam1, lam2], dim=-1), min=0.0))
  return sigma, v1, perp(v1)


def radii_from_cov(cov):
  """Square root of the larger eigenvalue."""
  a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
  d = a - c
  max_eig_sq = (a + c + torch.sqrt(d * d + 4.0 * b * b)) / 2.0
  return torch.sqrt(torch.clamp(max_eig_sq, min=0.0))


def radii_from_conic(conic):
  return radii_from_cov(inverse_cov(conic))


def ellipse_bounds(uv, v1, v2):
  """Axis-aligned bounds (lower, upper) of an ellipse with scaled axes v1
  and v2 about uv."""
  extent = torch.sqrt(v1 ** 2 + v2 ** 2)
  return uv - extent, uv + extent


def cov_axes(cov):
  """The covariance's axes scaled by their standard deviations."""
  sigma, v1, v2 = eig(cov)
  return v1 * sigma[..., 0:1], v2 * sigma[..., 1:2]


def conic_pdf(xy, uv, conic):
  """exp(-0.5 d^T C d), d = xy - uv, C in (..., 3) conic form."""
  d = xy - uv
  a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
  dx, dy = d[..., 0], d[..., 1]
  return torch.exp(-(0.5 * (dx * dx * a + dy * dy * c) + dx * dy * b))


def gaussian_pdf(xy, mean, axis, sigma):
  """Gaussian pdf in the eigen basis: axis the unit major eigenvector,
  sigma (..., 2) the standard deviations along it and its perpendicular."""
  d = xy - mean
  tx = dot(d, axis) / sigma[..., 0]
  ty = dot(d, perp(axis)) / sigma[..., 1]
  return torch.exp(-0.5 * (tx * tx + ty * ty))


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
