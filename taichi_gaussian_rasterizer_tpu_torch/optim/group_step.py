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

import ctypes
import math
from typing import Optional

import torch

from ..utils.cuda_build import CudaKernel
from . import kernels
from .kernels import MomentState

_P, _L, _I, _F, _D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float, ctypes.c_double)
OPTIM_STEP = CudaKernel("optim.cu", "tgr_optim_step",
                        [_P, _P, _P, _P, _L, _L, _I, _I, _I, _P, _P, _P, _F, _F,
                         _P, _P, _P, _P, _F, _F, _D, _I, _P])
RULES = {"adam": 0, "laprop": 1}


def _ptr(t: Optional[torch.Tensor]):
  return None if t is None else t.data_ptr()


def _float32_input(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
  """A float32 input of the kernel on `device` with `shape`, contiguous."""
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, the parameters on {device}")
  if t.dtype != torch.float32:
    raise TypeError(f"the CUDA optimizer step takes {name} in float32, got {t.dtype}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
  return t.contiguous()


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
  """The kernel: one launch, after checking every input's device, dtype,
  shape and contiguity."""
  device, dtype = param.device, param.dtype
  if device.type != "cuda":
    raise ValueError(f"the optimizer kernel runs on CUDA tensors, got {device}")
  if dtype not in (torch.float32, torch.float64):
    raise TypeError(f"the CUDA optimizer step takes float32 or float64 "
                    f"parameters, got {dtype}")
  if not param.is_contiguous():
    raise ValueError("the CUDA optimizer step updates contiguous parameters in place")
  if rule not in RULES:
    raise ValueError(f"unknown update rule {rule!r}")
  vector = kind in ("vector", "local_vector")
  if kind not in ("scalar", "vector", "local_vector"):
    raise ValueError(f"unknown group type {kind!r}")
  n, d = param.shape[0], math.prod(param.shape[1:])
  grad = _float32_input("grad", grad, (n, d), device)
  m, v = state
  for name, t, shape in (("m", m, (n, d)), ("v", v, (n,) if vector else (n, d))):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
        or not t.is_contiguous():
      raise ValueError(f"state {name} must be a contiguous {dtype} {shape} on "
                       f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
  weight = _float32_input("weight", weight, (n,), device)
  total_weight = _float32_input("total_weight", total_weight, (n,), device)
  lr = _float32_input("lr", lr.reshape(1), (1,), device)
  if visibility is not None:
    visibility = _float32_input("visibility", visibility, (n,), device)
  if point_lr is not None:
    point_lr = _float32_input("point_lr", point_lr, (n,), device)
  if mask_lr is not None:
    mask_lr = _float32_input("mask_lr", mask_lr, (d,), device)
  if basis is not None:
    if not vector:
      raise ValueError("a basis rotates the step of a vector group only")
    basis = _float32_input("basis", basis, (n, d, d), device)
  OPTIM_STEP.launch(
      param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(), n, d,
      int(dtype == torch.float64), RULES[rule], int(vector), weight.data_ptr(),
      total_weight.data_ptr(), _ptr(visibility), grad_scale, vis_smooth,
      _ptr(point_lr), _ptr(mask_lr), _ptr(basis), lr.data_ptr(), betas[0],
      betas[1], eps, int(bias_correction),
      torch.cuda.current_stream(device).cuda_stream)
