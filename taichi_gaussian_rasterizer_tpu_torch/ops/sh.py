"""Spherical-harmonics shading (port of `taichi_gaussian_rasterizer_tpu.ops.sh`).

Real cartesian SH bases of degree 0-3. `evaluate_sh_at` is the one entry
point. On CUDA tensors it runs the hand-written kernels `csrc/sh.cu`, one
each way, inside the autograd Function `_ShadeSH`, or raises: the forward
builds each point's basis in registers and writes only the clamped colour
(and, when a gradient will be taken, the clamp's byte gate), and the
backward recomputes the basis from the positions. On CPU tensors it runs
`evaluate_sh_plain`, the basis as plain torch and the contraction as an
einsum, which autograd differentiates. Nothing falls back from the
kernels to the plain version. `num_sh_coeffs` is left out: no caller in
the port.
"""

import math
from typing import Optional

import torch

from ..utils import tracing
from ..utils.cuda_build import CudaKernel, aligned
from . import lib

# the coefficients and their gradient are read and written as 16-byte
# vectors where a row is whole vectors
SH_FORWARD = CudaKernel("sh.cu", "tgr_sh_forward", """
    real@16 sh, real positions, real camera, long long n, int channels,
    int k, int double_precision, real color, u8? mask""")
SH_BACKWARD = CudaKernel("sh.cu", "tgr_sh_backward", """
    real grad, u8 mask, real positions, real camera, real@16? sh,
    long long n, int channels, int k, int double_precision, real@16? d_sh,
    real? d_dir""")


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


def evaluate_sh_plain(sh_params: torch.Tensor, positions: torch.Tensor,
                      camera_pos: torch.Tensor) -> torch.Tensor:
  """The plain version: clamp(einsum(sh, basis) + 0.5, 0, 1), (N, C)."""
  view_dir = lib.safe_normalize(positions - camera_pos)
  basis = rsh_cart(view_dir, check_sh_degree(sh_params))   # (N, K)
  color = torch.einsum("nck,nk->nc", sh_params, basis)     # (N, C)
  return torch.clamp(color + 0.5, 0.0, 1.0)


def _kernel_inputs(sh_params: torch.Tensor, positions: torch.Tensor,
                   camera_pos: torch.Tensor):
  """The kernels' inputs: their shapes checked, contiguous, the
  coefficients 16-byte aligned."""
  n, c, k = sh_params.shape
  if positions.shape != (n, 3) or camera_pos.shape != (3,):
    raise ValueError(f"positions must be ({n}, 3) and camera_pos (3,), got "
                     f"{tuple(positions.shape)} and {tuple(camera_pos.shape)}")
  if check_sh_degree(sh_params) > 3:
    raise ValueError(f"SH degree must be 0..3, got K = {k}")
  if n * c * k >= 2 ** 31:
    raise ValueError(f"the CUDA SH kernels take fewer than 2^31 coefficients, "
                     f"got {n} x {c} x {k}")
  return aligned(sh_params, 16), positions.contiguous(), camera_pos.contiguous()


def _launch_forward(sh: torch.Tensor, positions: torch.Tensor,
                    camera_pos: torch.Tensor, gate: bool):
  """The forward kernel: (colour (N, C), the clamp's gate (N, C) uint8 or
  None)."""
  n, c, k = sh.shape
  color = sh.new_empty((n, c))
  mask = torch.empty((n, c), dtype=torch.uint8, device=sh.device) if gate else None
  SH_FORWARD.launch(sh, positions, camera_pos, n, c, k,
                    sh.dtype == torch.float64, color, mask)
  return color, mask


def _launch_backward(grad: torch.Tensor, mask: torch.Tensor,
                     positions: torch.Tensor, camera_pos: torch.Tensor,
                     sh: Optional[torch.Tensor], k: int, want_sh: bool):
  """The backward kernel: (d_sh (N, C, K) or None, and with `sh` each
  (point, channel) row's share of d(position - camera) (N, C, 3), or
  None)."""
  n, c = grad.shape
  d_sh = grad.new_empty((n, c, k)) if want_sh else None
  d_dir = grad.new_empty((n, c, 3)) if sh is not None else None
  SH_BACKWARD.launch(grad, mask, positions, camera_pos, sh, n, c, k,
                     grad.dtype == torch.float64, d_sh, d_dir)
  return d_sh, d_dir


class _ShadeSH(torch.autograd.Function):
  """SH shading as an autograd node: the forward kernel, and the backward
  kernel with the gradients of the inputs that require them compiled in.
  Saves the positions, the camera position and the clamp's byte gate,
  and the coefficients only for the positions' (or camera's) gradient;
  never the basis."""

  @staticmethod
  def forward(ctx, sh_params, positions, camera_pos, gate):
    ctx.trace_parent = tracing.current()
    sh, positions, camera_pos = _kernel_inputs(sh_params, positions, camera_pos)
    color, mask = _launch_forward(sh, positions, camera_pos, gate)
    ctx.k = sh.shape[2]
    ctx.want_dir = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
    ctx.save_for_backward(positions, camera_pos, mask,
                          sh if ctx.want_dir else None)
    return color

  @staticmethod
  def backward(ctx, grad_color):
    with tracing.span("sh.bwd", parent=ctx.trace_parent):
      positions, camera_pos, mask, sh = ctx.saved_tensors
      d_sh, d_dir = _launch_backward(grad_color.contiguous(), mask, positions,
                                     camera_pos, sh, ctx.k,
                                     ctx.needs_input_grad[0])
      d_pos = d_cam = None
      if d_dir is not None:
        d_v = d_dir.sum(1)
        d_pos = d_v if ctx.needs_input_grad[1] else None
        d_cam = -d_v.sum(0) if ctx.needs_input_grad[2] else None
    return d_sh, d_pos, d_cam, None


def evaluate_sh_cuda(sh_params: torch.Tensor, positions: torch.Tensor,
                     camera_pos: torch.Tensor) -> torch.Tensor:
  """The kernels, differentiable wrt the inputs that require grad."""
  inputs = (sh_params, positions, camera_pos)
  gate = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
  return _ShadeSH.apply(*inputs, gate)


def evaluate_sh_at(
    sh_params: torch.Tensor,   # (N, C, (d+1)^2) coefficients
    positions: torch.Tensor,   # (N, 3) gaussian positions
    camera_pos: torch.Tensor,  # (3,)
    indexes: Optional[torch.Tensor] = None,  # optional (M,) gather indices
) -> torch.Tensor:
  """View-dependent SH colour clamped to [0, 1]: (N, C), or (M, C) with
  `indexes` (gathered in torch ahead of the kernels). Under a profile the
  span `tgr.sh` counts the rows shaded (`points`) and those the CUDA
  kernel shaded (`kernel_points`)."""
  check_sh_degree(sh_params)
  with tracing.span("sh") as span:
    if indexes is not None:
      sh_params = sh_params[indexes]
      positions = positions[indexes]
    points = sh_params.shape[0]
    if sh_params.is_cuda:
      color = evaluate_sh_cuda(sh_params, positions, camera_pos)
      span.count(points=points, kernel_points=points)
    elif sh_params.device.type == "cpu":
      color = evaluate_sh_plain(sh_params, positions, camera_pos)
      span.count(points=points, kernel_points=0)
    else:
      raise ValueError(f"no SH shading for device {sh_params.device}")
    return color
