"""The optimizer step of one parameter group, in place:
`ParameterClass.step` calls `step_group` once a group.

On CUDA tensors it is one launch of the hand-written kernel `csrc/optim.cu`
(`step_group_cuda`), or raises; on CPU tensors it is `step_group_plain`,
the plain passes of `kernels.py`. The kernel reads param, grad, m and v
once and writes param, m and v once, with the plain passes' operations in
their order and types. Its instance follows the step's rule (Adam or
LaProp), the group's kind (scalar; vector, which local_vector takes too,
with its basis) and the parameters' dtype (float32 or float64); the
optional tensors (visibility, point_lr, mask_lr, basis) are read where
given. The learning rate is read on the device, so the step adds no host
sync. Nothing falls back from the kernel to the plain version.
"""

import math
from typing import Optional

import torch

from ..utils.cuda_build import CudaKernel
from . import kernels
from .kernels import MomentState

OPTIM_STEP = CudaKernel("optim.cu", "tgr_optim_step", """
    real param, f32 grad, real m, real v, long long n, long long d,
    int double_precision, int rule, int vector_kind, f32 weight,
    f32 total_weight, f32? visibility, float grad_scale, float vis_smooth,
    f32? point_lr, f32? mask_lr, f32? basis, f32 lr, float beta1,
    float beta2, double eps, int bias_correction""")
RULES = {"adam": 0, "laprop": 1}


def step_group(param: torch.Tensor, grad: torch.Tensor, state: MomentState,
               weight: torch.Tensor, total_weight: torch.Tensor,
               lr: torch.Tensor, rule: str, kind: str,
               betas, eps: float, bias_correction: bool,
               visibility: Optional[torch.Tensor] = None,
               grad_scale: float = 1.0, vis_smooth: float = 0.01,
               point_lr: Optional[torch.Tensor] = None,
               mask_lr: Optional[torch.Tensor] = None,
               basis: Optional[torch.Tensor] = None) -> bool:
  """Step param (N, ...) and the group's moments `state` in place from
  grad (N, D) in float32, the per-point weight and total weight (this
  step's included) and the learning rate lr (a 0-d tensor), by `rule`
  (adam | laprop) for a group of type `kind`. `visibility` gives the
  visibility-aware gradient scale grad_scale / (visibility + vis_smooth)
  and its gate; `basis` (N, D, D) rotates a vector group's step (the
  caller rotates the gradient by its inverse beforehand). Returns whether
  the CUDA kernel stepped the group."""
  args = (param, grad, state, weight, total_weight, lr, rule, kind, betas,
          eps, bias_correction, visibility, grad_scale, vis_smooth, point_lr,
          mask_lr, basis)
  if param.is_cuda:
    step_group_cuda(*args)
    return True
  if param.device.type == "cpu":
    step_group_plain(*args)
    return False
  raise ValueError(f"no optimizer step for device {param.device}")


def visibility_scaled(grad, visibility, grad_scale, vis_smooth):
  """The gradient scaled by grad_scale / (visibility + vis_smooth) where
  visible, 0 elsewhere."""
  scale = grad_scale / (visibility + vis_smooth)
  return torch.where((visibility > 0)[:, None], grad * scale[:, None],
                     torch.zeros_like(grad))


def step_group_plain(param, grad, state, weight, total_weight, lr, rule, kind,
                     betas, eps, bias_correction, visibility=None,
                     grad_scale=1.0, vis_smooth=0.01, point_lr=None,
                     mask_lr=None, basis=None) -> None:
  """The plain version: `kernels.py`'s passes, on any device."""
  if visibility is not None:
    grad = visibility_scaled(grad, visibility, grad_scale, vis_smooth)
  lr_step, new = kernels.KERNELS[rule](grad, state, weight, total_weight, betas,
                                       eps, bias_correction, kind)
  if basis is not None:
    lr_step = kernels.rotate_to_basis(lr_step, basis, inverse=False)
  if mask_lr is not None:
    lr_step = lr_step * mask_lr[None, :]
  if point_lr is not None:
    lr_step = lr_step * point_lr[:, None]
  damp = kernels.saturate(weight)[:, None]
  update = (lr_step * damp * lr.to(param.dtype)).to(param.dtype)
  param.sub_(update.reshape(param.shape))
  state.m.copy_(new.m)
  state.v.copy_(new.v)


def step_group_cuda(param, grad, state, weight, total_weight, lr, rule, kind,
                    betas, eps, bias_correction, visibility=None,
                    grad_scale=1.0, vis_smooth=0.01, point_lr=None,
                    mask_lr=None, basis=None) -> None:
  """The kernel: one launch, after checking every input's shape."""
  if rule not in RULES:
    raise ValueError(f"unknown update rule {rule!r}")
  vector = kind in ("vector", "local_vector")
  if kind not in ("scalar", "vector", "local_vector"):
    raise ValueError(f"unknown group type {kind!r}")
  if basis is not None and not vector:
    raise ValueError("a basis rotates the step of a vector group only")
  n, d = param.shape[0], math.prod(param.shape[1:])
  m, v = state
  # the kernel reads its float32 inputs packed, and they may come strided
  # (the 2D trainer's gradients are column views of the reduction's sums)
  grad, weight, total_weight, visibility, point_lr, mask_lr, basis = (
      None if t is None else t.contiguous() for t in
      (grad, weight, total_weight, visibility, point_lr, mask_lr, basis))
  for name, t, shape in (
      ("grad", grad, (n, d)), ("m", m, (n, d)),
      ("v", v, (n,) if vector else (n, d)), ("weight", weight, (n,)),
      ("total_weight", total_weight, (n,)), ("visibility", visibility, (n,)),
      ("point_lr", point_lr, (n,)), ("mask_lr", mask_lr, (d,)),
      ("basis", basis, (n, d, d))):
    if t is not None and tuple(t.shape) != shape:
      raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
  OPTIM_STEP.launch(
      param, grad, m, v, n, d, param.dtype == torch.float64, RULES[rule],
      vector, weight, total_weight, visibility, grad_scale, vis_smooth,
      point_lr, mask_lr, basis, lr.reshape(1), betas[0], betas[1], eps,
      bias_correction)
