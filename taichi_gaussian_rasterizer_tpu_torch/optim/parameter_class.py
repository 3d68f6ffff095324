"""Parameters and optimizer state kept in sync under point resampling
(port of `taichi_gaussian_rasterizer_tpu.optim.parameter_class`).

A `ParameterClass` holds named (N, ...) tensors, each optimized group's
moments, the shared per-point state (total_weight, running_vis) and the
learning rates. Torch idiom where the JAX class is a pure pytree:

* `step` updates the tensors and moments in place, under
  `torch.no_grad()`, with the dense mask-form update of `kernels.py`
  (weight 0 is exactly a no-op), as one CUDA kernel a group on the card
  (`group_step.py`), and returns the instance;
* indexing (`params[mask]`) and `append_tensors`, which change N, return
  a new instance whose every per-point tensor and state is filtered or
  zero-extended together; `replace`, `replace_tensors` and
  `set_learning_rate` return an instance that shares the other tensors;
* learning rates are float32 tensors, as in the JAX class, so a schedule
  changes values and never shapes; `create` makes the shared state
  total_weight and running_vis float32 too, and a step replaces them with
  the promoted result, as the JAX step does.

`from_state_dict` takes the numpy dict that either package's
`state_dict()` returns, so training state carries over from the JAX
package unchanged.
"""

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import tracing
from . import group_step, kernels
from .kernels import MomentState


@dataclass(frozen=True)
class GroupConfig:
  """Static per-parameter-group configuration."""
  type: str = "scalar"          # scalar | vector | local_vector
  betas: Tuple[float, float] = (0.9, 0.999)
  eps: float = 1e-16
  bias_correction: bool = True


@dataclass(frozen=True)
class OptimizerSpec:
  """Which update rule `step` applies (fractional, sparse or
  visibility-aware Adam / LaProp)."""
  kernel: str = "adam"          # adam | laprop
  visibility_aware: bool = False
  vis_beta: float = 0.9
  vis_smooth: float = 0.01
  grad_scale: float = 1.0


FractionalAdam = OptimizerSpec(kernel="adam")
FractionalLaProp = OptimizerSpec(kernel="laprop")
SparseAdam = FractionalAdam          # step(weight=visible mask as 0/1)
SparseLaProp = FractionalLaProp
VisibilityAwareAdam = OptimizerSpec(kernel="adam", visibility_aware=True)
VisibilityAwareLaProp = OptimizerSpec(kernel="laprop", visibility_aware=True)


def _flat(x: torch.Tensor) -> torch.Tensor:
  return x.reshape(x.shape[0], -1)


@dataclass
class ParameterClass:
  tensors: Dict[str, torch.Tensor]
  state: Dict[str, MomentState]
  learning_rates: Dict[str, torch.Tensor]
  total_weight: torch.Tensor                   # (N,) float32
  running_vis: torch.Tensor                    # (N,) float32
  point_lr: Dict[str, Optional[torch.Tensor]]
  mask_lr: Dict[str, Optional[torch.Tensor]]
  groups: Tuple[Tuple[str, GroupConfig], ...]
  optimizer: OptimizerSpec

  @staticmethod
  def create(tensors: Dict[str, torch.Tensor],
             parameter_groups: Dict[str, Dict[str, Any]],
             optimizer: OptimizerSpec = VisibilityAwareAdam,
             lr: float = 0.001,
             betas: Tuple[float, float] = (0.9, 0.999),
             eps: float = 1e-16,
             bias_correction: bool = True) -> "ParameterClass":
    """parameter_groups: name -> {lr, type, betas, eps, bias_correction,
    mask_lr, point_lr} (all optional; the name must be one of tensors)."""
    first = next(iter(tensors.values()))
    n, device = first.shape[0], first.device
    groups, lrs, state, point_lr, mask_lr = {}, {}, {}, {}, {}
    for name, cfg in parameter_groups.items():
      if name not in tensors:
        raise KeyError(f"group {name} not in tensors")
      groups[name] = GroupConfig(
          type=cfg.get("type", "scalar"),
          betas=tuple(cfg.get("betas", betas)),
          eps=cfg.get("eps", eps),
          bias_correction=cfg.get("bias_correction", bias_correction))
      lrs[name] = torch.tensor(float(cfg.get("lr", lr)), dtype=torch.float32,
                               device=device)
      state[name] = kernels.init_state(_flat(tensors[name]), groups[name].type)
      point_lr[name] = cfg.get("point_lr", None)
      mask_lr[name] = cfg.get("mask_lr", None)

    return ParameterClass(
        tensors=dict(tensors),
        state=state,
        learning_rates=lrs,
        total_weight=torch.zeros(n, dtype=torch.float32, device=device),
        running_vis=torch.zeros(n, dtype=torch.float32, device=device),
        point_lr=point_lr,
        mask_lr=mask_lr,
        groups=tuple(sorted(groups.items())),
        optimizer=optimizer)

  @property
  def group_dict(self) -> Dict[str, GroupConfig]:
    return dict(self.groups)

  @property
  def batch_size(self):
    return next(iter(self.tensors.values())).shape[:1]

  @property
  def num_points(self) -> int:
    return self.batch_size[0]

  @property
  def device(self) -> torch.device:
    return self.total_weight.device

  def keys(self):
    return self.tensors.keys()

  def optimized_keys(self):
    return [k for k, _ in self.groups]

  def items(self):
    return self.tensors.items()

  def __getattr__(self, name):
    tensors = self.__dict__.get("tensors", {})
    if name in tensors:
      return tensors[name]
    raise AttributeError(name)

  def replace(self, **kwargs) -> "ParameterClass":
    return replace(self, **kwargs)

  def replace_tensors(self, **tensors) -> "ParameterClass":
    return replace(self, tensors={**self.tensors, **tensors})

  # -- learning rates -------------------------------------------------
  def set_learning_rate(self, **kwargs) -> "ParameterClass":
    lrs = dict(self.learning_rates)
    for k, v in kwargs.items():
      if k not in lrs:
        raise KeyError(f"unknown group {k}")
      lrs[k] = torch.tensor(float(v), dtype=torch.float32, device=self.device)
    return replace(self, learning_rates=lrs)

  def update_groups(self, **kwargs) -> "ParameterClass":
    return self.set_learning_rate(
        **{k: v["lr"] for k, v in kwargs.items() if "lr" in v})

  # -- point resampling ------------------------------------------------
  def __getitem__(self, idx) -> "ParameterClass":
    """Filter points: an index or mask applies to the parameters and to
    every piece of per-point optimizer state."""
    def take(x):
      return None if x is None else x[idx]
    return replace(
        self,
        tensors={k: take(v) for k, v in self.tensors.items()},
        state={k: MomentState(take(s.m), take(s.v))
               for k, s in self.state.items()},
        total_weight=take(self.total_weight),
        running_vis=take(self.running_vis),
        point_lr={k: take(v) for k, v in self.point_lr.items()})

  def append_tensors(self, tensors: Dict[str, torch.Tensor]) -> "ParameterClass":
    """Concatenate new points with zero-initialized optimizer state."""
    if set(tensors) != set(self.tensors):
      raise KeyError(f"keys mismatch: {sorted(tensors)} != {sorted(self.tensors)}")
    m = next(iter(tensors.values())).shape[0]

    def cat(a, b):
      return torch.cat([a, b], dim=0)

    def zeros(x):
      return x.new_zeros(m)

    new_state = {}
    for k, s in self.state.items():
      z = kernels.init_state(_flat(tensors[k]), self.group_dict[k].type)
      new_state[k] = MomentState(cat(s.m, z.m), cat(s.v, z.v))
    return replace(
        self,
        tensors={k: cat(v, tensors[k]) for k, v in self.tensors.items()},
        state=new_state,
        total_weight=cat(self.total_weight, zeros(self.total_weight)),
        running_vis=cat(self.running_vis, zeros(self.running_vis)),
        point_lr={k: None if v is None else cat(v, zeros(v))
                  for k, v in self.point_lr.items()})

  def concat(self, other: "ParameterClass") -> "ParameterClass":
    return self.append_tensors(other.tensors)

  # -- the optimizer step ----------------------------------------------
  @torch.no_grad()
  def step(self, grads: Dict[str, torch.Tensor],
           visibility: Optional[torch.Tensor] = None,
           weight: Optional[torch.Tensor] = None,
           basis: Optional[torch.Tensor] = None) -> "ParameterClass":
    """Sparse optimizer step in dense mask form: the tensors and moments
    in place, the shared state replaced.

    grads: name -> (N, ...) gradients for (a subset of) optimized keys;
      they are taken in float32, as the JAX step takes them.
    visibility: (N,) per-point visibility, 0 = not visible (required by
      visibility-aware optimizers).
    weight: (N,) explicit fractional weights (fractional optimizers);
      defaults to (visibility > 0).
    basis: (N, D, D) per-point basis for local_vector groups.
    Each group is one `group_step.step_group`: on a CUDA device one launch
    of the kernel `csrc/optim.cu`, on the CPU the plain passes of
    `kernels.py`, with the same values.
    Returns self. Under a torch.profiler profile the step is the span
    `tgr.optim.step` of `utils.tracing`, counting the elements stepped
    (`elements`, the sum of N * D over the groups) and those the CUDA
    kernel stepped (`kernel_elements`).
    """
    with tracing.span("optim.step") as span:
      return self._step(grads, visibility, weight, basis, span)

  def _step(self, grads, visibility, weight, basis, span) -> "ParameterClass":
    spec = self.optimizer
    if spec.visibility_aware:
      if visibility is None:
        raise ValueError("a visibility-aware step needs visibility")
      self.running_vis, weight = kernels.update_visibility(
          self.running_vis, visibility, visibility > 0, beta=spec.vis_beta)
    elif weight is None:
      if visibility is None:
        raise ValueError("a step needs weight or visibility")
      weight = (visibility > 0).to(torch.float32)

    self.total_weight = total_weight = self.total_weight + weight
    elements = kernel_elements = 0

    for name, cfg in self.groups:
      if grads.get(name) is None:
        continue
      param = self.tensors[name]
      grad = _flat(grads[name]).to(torch.float32)
      vis = visibility if spec.visibility_aware else None
      if cfg.type == "local_vector":
        if basis is None:
          raise ValueError("a local_vector group needs a basis")
        if vis is not None:   # the scale comes ahead of the rotation
          grad = group_step.visibility_scaled(grad, vis, spec.grad_scale,
                                               spec.vis_smooth)
          vis = None
        grad = kernels.rotate_to_basis(grad, basis, inverse=True)

      on_kernel = group_step.step_group(
          param, grad, self.state[name], weight, total_weight,
          self.learning_rates[name], spec.kernel, cfg.type, cfg.betas, cfg.eps,
          cfg.bias_correction, visibility=vis, grad_scale=spec.grad_scale,
          vis_smooth=spec.vis_smooth, point_lr=self.point_lr[name],
          mask_lr=self.mask_lr[name],
          basis=basis if cfg.type == "local_vector" else None)
      elements += grad.numel()
      kernel_elements += grad.numel() if on_kernel else 0
    span.count(elements=elements, kernel_elements=kernel_elements)
    return self

  # -- checkpointing -----------------------------------------------------
  def state_dict(self) -> Dict[str, Any]:
    """Numpy snapshot in the JAX class's layout: parameters, optimizer
    state and group hyperparameters."""
    def to_np(t):
      return None if t is None else t.detach().cpu().numpy()
    return {
        "tensors": {k: to_np(v) for k, v in self.tensors.items()},
        "state": {k: {"m": to_np(s.m), "v": to_np(s.v)}
                  for k, s in self.state.items()},
        "learning_rates": {k: to_np(v) for k, v in self.learning_rates.items()},
        "total_weight": to_np(self.total_weight),
        "running_vis": to_np(self.running_vis),
        "point_lr": {k: to_np(v) for k, v in self.point_lr.items()},
        "mask_lr": {k: to_np(v) for k, v in self.mask_lr.items()},
        "groups": {k: vars(v) for k, v in self.groups},
        "optimizer": vars(self.optimizer),
    }

  @staticmethod
  def from_state_dict(state: Dict[str, Any],
                      device="cuda") -> "ParameterClass":
    """Rebuild from a `state_dict()` of this class or of the JAX
    package's, on `device`, keeping every array's dtype."""
    def to_t(x):
      return None if x is None else torch.as_tensor(
          np.array(x), device=device)
    groups = tuple(sorted(
        (k, GroupConfig(**{**v, "betas": tuple(v["betas"])}))
        for k, v in state["groups"].items()))
    return ParameterClass(
        tensors={k: to_t(v) for k, v in state["tensors"].items()},
        state={k: MomentState(to_t(s["m"]), to_t(s["v"]))
               for k, s in state["state"].items()},
        learning_rates={k: to_t(v) for k, v in state["learning_rates"].items()},
        total_weight=to_t(state["total_weight"]),
        running_vis=to_t(state["running_vis"]),
        point_lr={k: to_t(v) for k, v in state["point_lr"].items()},
        mask_lr={k: to_t(v) for k, v in state["mask_lr"].items()},
        groups=groups,
        optimizer=OptimizerSpec(**state["optimizer"]))
