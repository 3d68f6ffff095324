"""Dense, mask-form optimizer update math (port of
`taichi_gaussian_rasterizer_tpu.optim.kernels`), function for function.

The per-point fractional weight w raises each EMA decay to the w-th
power, lerp(beta^w, m, g), so w = 0 is exactly a no-op (beta^0 = 1):
invisible points need no gather or scatter, and the whole update is a
dense (N, D) elementwise pass in plain torch. It runs outside any Pallas
kernel in the JAX package too.

Variants:
* scalar: a second moment per component, v (N, D)
* vector: one second moment per point, the squared gradient norm, v (N,)
* local_vector: vector, with the gradient rotated into a per-point basis
  before the step and back after
"""

from typing import NamedTuple, Tuple

import torch


def saturate(x):
  """Step damping 1 - exp(-2x)."""
  return 1.0 - torch.exp(-2.0 * x)


def _ema(decay, old, new):
  """EMA with a per-element decay."""
  return old * decay + new * (1.0 - decay)


class MomentState(NamedTuple):
  m: torch.Tensor  # (N, D) first moment
  v: torch.Tensor  # (N, D) scalar type / (N,) vector types: second moment


def _vector_kind(kind: str) -> bool:
  return kind in ("vector", "local_vector")


def init_state(param: torch.Tensor, kind: str) -> MomentState:
  n, d = param.shape
  m = param.new_zeros(n, d)
  v = param.new_zeros((n,) if _vector_kind(kind) else (n, d))
  return MomentState(m, v)


def _bias_factors(betas, total_weight, bias_correction):
  """(1 - beta^total) factors, NaN-safe at total == 0 (never-stepped
  points, where the step is zero anyway because the weight is 0)."""
  beta1, beta2 = betas
  stepped = (total_weight > 0)[:, None]
  t = torch.where(stepped, total_weight[:, None], torch.ones_like(total_weight[:, None]))
  one = torch.ones_like(t)
  if not bias_correction:
    return one, one
  return (torch.where(stepped, 1.0 - beta1 ** t, one),
          torch.where(stepped, 1.0 - beta2 ** t, one))


def _masked_grad(grad, w):
  # guard NaN gradients at skipped points
  return torch.where(w > 0, grad, torch.zeros_like(grad))


def adam_lr_step(grad: torch.Tensor, state: MomentState, weight: torch.Tensor,
                 total_weight: torch.Tensor, betas: Tuple[float, float],
                 eps: float, bias_correction: bool, kind: str):
  """Fractional Adam.

  grad: (N, D); weight: (N,) fractional step weights (0 = skip);
  total_weight: (N,) accumulated weights including this step.
  Returns (lr_step (N, D) to be scaled by the learning rate, new
  MomentState).
  """
  beta1, beta2 = betas
  w = weight[:, None]
  grad = _masked_grad(grad, w)

  m = _ema(beta1 ** w, state.m, grad)
  if _vector_kind(kind):
    norm = torch.sum(grad * grad, dim=1)
    v = _ema(beta2 ** weight, state.v, norm)
    denom = torch.clamp(torch.sqrt(v), min=eps)[:, None]
  else:
    v = _ema(beta2 ** w, state.v, grad * grad)
    denom = torch.clamp(torch.sqrt(v), min=eps)

  bias1, bias2 = _bias_factors(betas, total_weight, bias_correction)
  lr_step = m / denom * (torch.sqrt(bias2) / bias1)
  return lr_step, MomentState(m, v)


def laprop_lr_step(grad: torch.Tensor, state: MomentState, weight: torch.Tensor,
                   total_weight: torch.Tensor, betas: Tuple[float, float],
                   eps: float, bias_correction: bool, kind: str):
  """Fractional LaProp: the gradient is normalized by sqrt(v) before the
  momentum average."""
  beta1, beta2 = betas
  w = weight[:, None]
  grad = _masked_grad(grad, w)

  bias1, bias2 = _bias_factors(betas, total_weight, bias_correction)

  if _vector_kind(kind):
    norm = torch.sum(grad * grad, dim=1)
    v = _ema(beta2 ** weight, state.v, norm)
    normed = grad / torch.clamp(torch.sqrt(v[:, None] / bias2), min=eps)
  else:
    v = _ema(beta2 ** w, state.v, grad * grad)
    normed = grad / torch.clamp(torch.sqrt(v / bias2), min=eps)

  m = _ema(beta1 ** w, state.m, normed)
  return m / bias1, MomentState(m, v)


KERNELS = {"adam": adam_lr_step, "laprop": laprop_lr_step}


def rotate_to_basis(x: torch.Tensor, basis: torch.Tensor, inverse: bool):
  """Apply (or invert) a per-point basis (N, D, D) to (N, D) vectors.

  The JAX code inverts with `jnp.linalg.inv` and applies with an einsum.
  Here a 2x2 basis (the 2D trainer's `point_basis`) is inverted in closed
  form, adj(B) / det(B), and every basis is applied as a broadcast
  multiply and sum, all elementwise: on the card a batched
  `torch.linalg.inv` over a million 2x2 matrices is a library solver
  call, and the einsum became cuBLAS batched matrix-vector kernels that
  took a third of the optimizer step. Other sizes are inverted with
  `torch.linalg.inv`. The two operands are promoted to a common dtype, as
  the JAX einsum promotes them."""
  dtype = torch.promote_types(x.dtype, basis.dtype)
  x, basis = x.to(dtype), basis.to(dtype)
  if inverse:
    if basis.shape[-2:] == (2, 2):
      a, b = basis[:, 0, 0], basis[:, 0, 1]
      c, d = basis[:, 1, 0], basis[:, 1, 1]
      det = a * d - b * c
      basis = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2) / det[:, None, None]
    else:
      basis = torch.linalg.inv(basis)
  return torch.sum(basis * x[:, None, :], dim=-1)


def exp_lerp(t, a, b):
  """Numerically stable log-space lerp."""
  mx = torch.maximum(a, b)
  return mx + torch.log(torch.exp(a - mx) * (1 - t) + torch.exp(b - mx) * t)


def power_lerp(t, a, b, k: int = 4):
  """lerp in the k-th power domain."""
  return (a ** k + (b ** k - a ** k) * t) ** (1.0 / k)


def update_visibility(running_vis: torch.Tensor, visibility: torch.Tensor,
                      visible: torch.Tensor, beta: float = 0.9,
                      eps: float = 1e-12, k: int = 4):
  """Running-visibility EMA and the step weight it gives, mask form.

  visible: (N,) bool; invisible entries keep their running value and get
  weight 0. Returns (new running visibility, weight)."""
  updated = power_lerp(beta, visibility, running_vis, k=k)
  new_running = torch.where(visible, updated, running_vis)
  weight = torch.where(visible, visibility / torch.clamp(updated, min=eps),
                       torch.zeros_like(visibility))
  return new_running, weight
