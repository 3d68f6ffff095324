"""Spherical-harmonics shading (port of `taichi_gaussian_rasterizer_tpu.ops.sh`).

Real cartesian SH bases of degree 0-3, evaluated for all N points in
plain torch; autograd gives the backward. `num_sh_coeffs` is left out: no
caller in the port.
"""

import math
from typing import Optional

import torch

from ..utils import tracing
from . import lib


def check_sh_degree(sh_features: torch.Tensor) -> int:
  """(N, C, K) -> degree; K must be a square."""
  if sh_features.ndim != 3:
    raise ValueError(
        f"SH features must have 3 dimensions, got {tuple(sh_features.shape)}")
  n_sh = sh_features.shape[2]
  n = int(math.isqrt(n_sh))
  if n * n != n_sh:
    raise ValueError(f"SH feature count must be square, got {n_sh}")
  return n - 1


def rsh_cart(xyz: torch.Tensor, degree: int) -> torch.Tensor:
  """Real cartesian SH basis: (..., 3) unit directions -> (..., (degree+1)^2)."""
  if not 0 <= degree <= 3:
    raise ValueError(f"SH degree must be 0..3, got {degree}")
  x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

  out = [torch.full_like(x, 0.282094791773878)]
  if degree >= 1:
    out += [
        -0.48860251190292 * y,
        0.48860251190292 * z,
        -0.48860251190292 * x,
    ]
  if degree >= 2:
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    out += [
        1.09254843059208 * xy,
        -1.09254843059208 * yz,
        0.94617469575756 * z2 - 0.31539156525252,
        -1.09254843059208 * xz,
        0.54627421529604 * (x2 - y2),
    ]
  if degree >= 3:
    out += [
        -0.590043589926644 * y * (3.0 * x2 - y2),
        2.89061144264055 * xy * z,
        0.304697199642977 * y * (1.5 - 7.5 * z2),
        1.24392110863372 * z * (1.5 * z2 - 0.5) - 0.497568443453487 * z,
        0.304697199642977 * x * (1.5 - 7.5 * z2),
        1.44530572132028 * z * (x2 - y2),
        -0.590043589926644 * x * (x2 - 3.0 * y2),
    ]
  return torch.stack(out, dim=-1)


def evaluate_sh_at(
    sh_params: torch.Tensor,   # (N, C, (d+1)^2) coefficients
    positions: torch.Tensor,   # (N, 3) gaussian positions
    camera_pos: torch.Tensor,  # (3,)
    indexes: Optional[torch.Tensor] = None,  # optional (M,) gather indices
) -> torch.Tensor:
  """View-dependent SH colour clamped to [0, 1]: (N, C), or (M, C) with
  `indexes`."""
  degree = check_sh_degree(sh_params)
  with tracing.span("sh"):
    if indexes is not None:
      sh_params = sh_params[indexes]
      positions = positions[indexes]

    view_dir = lib.safe_normalize(positions - camera_pos)
    basis = rsh_cart(view_dir, degree)                        # (N, K)
    color = torch.einsum("nck,nk->nc", sh_params, basis)      # (N, C)
    return torch.clamp(color + 0.5, 0.0, 1.0)
