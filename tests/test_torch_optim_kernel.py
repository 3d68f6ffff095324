"""The optimizer step's kernel (`csrc/optim.cu`, `optim/group_step.py`):
on the card, `ParameterClass.step` through the kernel against the same
step through the plain passes, for every instance; on the CPU, the
dispatch. Card tests are marked `cuda` and skip without an NVIDIA GPU.
This file imports no JAX; on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_optim_kernel.py

The kernel takes the plain passes' operations in their order and types,
each rounded on its own (no fused multiply-adds), and the same CUDA math
library's powf and expf for the per-point scalars, so a scalar group
compares bit for bit: parameters and moments after every step. A vector
or local_vector group adds a row's squared gradients (and the basis's
products) in row order, which torch.sum on the card does not always do
(for one 3-value row in five the second moment differs in the last
place), so those compare within VECTOR_RTOL of the largest plain value:
a few float32 roundings carried over four steps (on an H100 the largest
seen is 1.4e-7). Rows never stepped (weight 0)
are left as they were, bit for bit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from taichi_gaussian_rasterizer_tpu_torch.optim import group_step
from taichi_gaussian_rasterizer_tpu_torch.optim.kernels import MomentState

VECTOR_RTOL = chip_smoke.TOL_OPTIM_VECTOR


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rule,kind,visibility_aware,point_lr,mask_lr,dtype",
                         chip_smoke.OPTIM_CASES)
def test_kernel_steps_as_the_plain_passes(cuda_device, rule, kind,
                                          visibility_aware, point_lr, mask_lr,
                                          dtype):
  """Four steps of fractional weights through the kernel and through the
  plain passes on the card: the same values (module docstring), the same
  shared state, points never stepped and the tensor not optimized left
  as they were; one launch a group a step. The case matrix, the inputs
  and the comparison are chip_smoke.py's phase 12's."""
  case = (rule, kind, visibility_aware, point_lr, mask_lr, dtype)
  launches, worst = chip_smoke.optim_kernel_against_plain(
      case, cuda_device, n=5003, d=3, steps=4)
  assert launches == 2 * 4, launches
  assert worst["scalar"] == 0.0, worst
  assert worst["vector"] <= VECTOR_RTOL, worst


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 4, 5, 48, 128])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_takes_any_width_and_alignment(cuda_device, d, offset):
  """A scalar group of any width, at a 16-byte boundary or one value past
  it (the kernel then reads value by value): the plain passes' bits, and
  weight-0 rows unchanged."""
  n = 3001
  rng = np.random.default_rng(d)

  def placed(x, dtype=torch.float32):
    buf = torch.zeros(x.numel() + offset, dtype=dtype, device=cuda_device)
    buf[offset:] = x.reshape(-1).to(cuda_device, dtype)
    return buf[offset:].view(x.shape)

  base = dict(p=torch.tensor(rng.normal(size=(n, d))),
              m=torch.tensor(rng.normal(size=(n, d)) * 0.1),
              v=torch.tensor(rng.uniform(0, 0.01, (n, d))))
  grad = placed(torch.tensor(rng.normal(size=(n, d))))
  weight = torch.tensor(rng.uniform(0, 2, n) * (rng.uniform(size=n) > 0.2),
                        dtype=torch.float32, device=cuda_device)
  total = weight + 3.0
  lr = torch.tensor(0.01, device=cuda_device)
  out = []
  for fn in (group_step.step_group_cuda, group_step.step_group_plain):
    p, m, v = (placed(base[k]) for k in ("p", "m", "v"))
    fn(p, grad, MomentState(m, v), weight, total, lr, "adam", "scalar",
       (0.9, 0.999), 1e-16, True)
    out.append((p, m, v))
  for got, want in zip(*out):
    assert torch.equal(got, want), (got - want).abs().max().item()
  still = weight == 0
  assert torch.equal(out[0][0][still], placed(base["p"])[still])


def test_cpu_groups_take_the_plain_passes():
  """On CPU tensors `step_group` is the plain version and says so; the
  kernel's wrapper refuses them rather than fall back, and refuses
  float16 for its dtype, before any build; a strided gradient (the 2D
  trainer's are column views) is packed, not refused."""
  n, d = 50, 3
  rng = np.random.default_rng(2)
  p = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32)

  def args(param):
    state = MomentState(torch.zeros(n, d), torch.zeros(n, d))
    return (param, torch.ones(n, d), state, torch.ones(n), torch.ones(n),
            torch.tensor(0.1), "adam", "scalar", (0.9, 0.999), 1e-16, True)

  start, q = p.clone(), p.clone()
  assert group_step.step_group(*args(p)) is False
  group_step.step_group_plain(*args(q))
  assert torch.equal(p, q) and not torch.equal(p, start)
  with pytest.raises(ValueError, match="CUDA tensors"):
    group_step.step_group_cuda(*args(p))
  with pytest.raises(TypeError, match="float32 or float64"):
    group_step.step_group_cuda(*args(p.half()))
  strided = list(args(p))
  strided[1] = torch.ones(d, n).T
  with pytest.raises(ValueError, match="CUDA tensors"):
    group_step.step_group_cuda(*strided)
