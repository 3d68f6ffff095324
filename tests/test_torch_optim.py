"""The port's optimizers (`optim`) against the JAX package's, and the
cases of tests/test_optim.py in the port's in-place idiom.

Tolerances:
* parity with the JAX `ParameterClass.step`, float64 parameters, 5 steps
  of the same gradients, visibility and basis: rtol 1e-6, atol 1e-12.
  Both steps take the gradients in float32 (the JAX step casts them), so
  the two libraries' float32 rounding of the same products can differ
  in the last place; everything else is float64.
* the numpy Adam reference: rtol 2e-5, atol 2e-6, as in test_optim.
* a JAX `state_dict()` carried into the port: exact.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import optim as jax_optim

from taichi_gaussian_rasterizer_tpu_torch.optim import (
    FractionalAdam, FractionalLaProp, ParameterClass, VisibilityAwareAdam,
    VisibilityAwareLaProp, kernels)
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing


def make_params(n=16, d=3, seed=0, optimizer=FractionalAdam, **group_kw):
  rng = np.random.default_rng(seed)
  tensors = {
      "position": torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32),
      "alpha": torch.tensor(rng.normal(size=(n, 1)), dtype=torch.float32),
      "aux": torch.arange(n, dtype=torch.float32),  # not optimized
  }
  groups = {
      "position": dict(lr=0.1, type=group_kw.pop("pos_type", "scalar"),
                       **group_kw),
      "alpha": dict(lr=0.05, type="scalar"),
  }
  return ParameterClass.create(tensors, groups, optimizer=optimizer)


def numpy_adam_step(param, grad, m, v, t, lr, betas=(0.9, 0.999), eps=1e-16):
  """Standard Adam with a max(sqrt(v), eps) denominator and the
  1 - exp(-2) damping at weight 1."""
  b1, b2 = betas
  m = b1 * m + (1 - b1) * grad
  v = b2 * v + (1 - b2) * grad * grad
  bias = np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
  step = m / np.maximum(np.sqrt(v), eps) * bias * lr
  return param - step * (1 - np.exp(-2.0)), m, v


def test_fractional_adam_matches_dense_adam():
  """Every point visible at weight 1: fractional Adam (scalar) is numpy
  Adam with the saturate(1) damping, step after step."""
  p = make_params(n=8, d=3)
  pos = p.tensors["position"].double().numpy()
  m, v = np.zeros_like(pos), np.zeros_like(pos)
  rng = np.random.default_rng(42)
  vis = torch.ones(8)
  for t in range(1, 6):
    g = rng.normal(size=pos.shape).astype(np.float32)
    p = p.step({"position": torch.tensor(g)}, visibility=vis)
    pos, m, v = numpy_adam_step(pos, g.astype(np.float64), m, v, t, lr=0.1)
    np.testing.assert_allclose(p.tensors["position"].numpy(), pos,
                               rtol=2e-5, atol=2e-6)


def test_invisible_points_untouched():
  p = make_params(n=10)
  before = p.tensors["position"].clone()
  g = {"position": torch.ones(10, 3), "alpha": torch.ones(10, 1)}
  vis = torch.tensor([1.0] * 5 + [0.0] * 5)
  p2 = p.step(g, visibility=vis)
  assert p2 is p                   # the step is in place
  torch.testing.assert_close(p.tensors["position"][5:], before[5:], rtol=0, atol=0)
  assert (p.state["position"].m[5:] == 0).all()
  assert not (p.tensors["position"][:5] == before[:5]).all()
  torch.testing.assert_close(p.total_weight, vis, rtol=0, atol=0)


def test_fractional_weight_halves():
  """Two half-weight steps with the same gradient accumulate the total
  weight of one full step, and each moves the points."""
  p_full, p_half = make_params(n=4), make_params(n=4)
  start = p_full.tensors["position"].clone()
  g = {"position": torch.full((4, 3), 0.5)}
  p_full.step(g, weight=torch.ones(4), visibility=None)
  p_half.step(g, weight=torch.full((4,), 0.5))
  d_half1 = (p_half.tensors["position"] - start).abs().mean()
  p_half.step(g, weight=torch.full((4,), 0.5))
  torch.testing.assert_close(p_half.total_weight, p_full.total_weight)
  assert d_half1 > 0


@pytest.mark.parametrize("opt", [FractionalAdam, FractionalLaProp,
                                 VisibilityAwareAdam])
def test_convergence_quadratic(opt):
  """Each optimizer minimizes a simple quadratic on visible points."""
  target = torch.tensor([[1.0, -2.0, 0.5]] * 6)
  p = make_params(n=6, seed=3, optimizer=opt)
  vis = torch.ones(6) * 0.8
  for _ in range(300):
    p.step({"position": 2 * (p.tensors["position"] - target)}, visibility=vis)
  torch.testing.assert_close(p.tensors["position"], target, rtol=0, atol=0.05)


def test_local_vector_identity_basis_matches_vector():
  p_vec = make_params(n=5, pos_type="vector")
  p_loc = make_params(n=5, pos_type="local_vector")
  g = {"position": torch.tensor(np.random.default_rng(1).normal(size=(5, 3)),
                                dtype=torch.float32)}
  eye = torch.eye(3).expand(5, 3, 3)
  vis = torch.ones(5)
  p_vec.step(g, visibility=vis)
  p_loc.step(g, visibility=vis, basis=eye)
  torch.testing.assert_close(p_vec.tensors["position"], p_loc.tensors["position"],
                             rtol=1e-6, atol=0)


def test_rotate_to_basis_closed_form_inverse():
  """The closed-form 2x2 inverse undoes the basis, as torch.linalg.inv
  does (float64, atol 1e-12)."""
  rng = np.random.default_rng(9)
  basis = torch.tensor(rng.normal(size=(50, 2, 2)))
  x = torch.tensor(rng.normal(size=(50, 2)))
  y = kernels.rotate_to_basis(x, basis, inverse=True)
  torch.testing.assert_close(kernels.rotate_to_basis(y, basis, inverse=False), x,
                             rtol=0, atol=1e-12)
  torch.testing.assert_close(y, torch.einsum("nij,nj->ni", torch.linalg.inv(basis), x),
                             rtol=0, atol=1e-12)


def test_visibility_weighting_formula():
  """Running-visibility power lerp and step weight against numpy."""
  running = torch.tensor([0.5, 0.0, 2.0])
  vis = torch.tensor([1.0, 3.0, 0.0])
  new_run, w = kernels.update_visibility(running, vis, vis > 0, beta=0.5)
  up = (vis.numpy() ** 4 + (running.numpy() ** 4 - vis.numpy() ** 4) * 0.5) ** 0.25
  np.testing.assert_allclose(new_run.numpy()[:2], up[:2], rtol=1e-6)
  assert float(new_run[2]) == 2.0          # invisible: unchanged
  np.testing.assert_allclose(w.numpy()[:2], vis.numpy()[:2] / up[:2], rtol=1e-6)
  assert float(w[2]) == 0.0


def test_resampling_preserves_state():
  p = make_params(n=10)
  p.step({"position": torch.ones(10, 3)}, visibility=torch.ones(10))
  mask = torch.tensor([True, False] * 5)
  filtered = p[mask]
  assert filtered.num_points == 5
  torch.testing.assert_close(filtered.state["position"].m, p.state["position"].m[mask])
  torch.testing.assert_close(filtered.tensors["aux"], p.tensors["aux"][mask])

  grown = filtered.append_tensors({k: v[:3] for k, v in filtered.tensors.items()})
  assert grown.num_points == 8
  assert (grown.state["position"].m[5:] == 0).all()
  assert (grown.total_weight[5:] == 0).all()
  for s in grown.state.values():
    assert s.m.shape[0] == s.v.shape[0] == 8
  assert grown.running_vis.shape == (8,)


def test_set_learning_rate_changes_value_only():
  """The learning rate is a float32 0-d tensor: a new rate replaces the
  value (no shape or dtype changes), and the next step uses it."""
  p, q = make_params(n=4), make_params(n=4)
  g = {"position": torch.ones(4, 3)}
  q = q.set_learning_rate(position=0.5)
  assert q.learning_rates["position"].dtype == torch.float32
  assert q.learning_rates["position"].shape == p.learning_rates["position"].shape
  start = p.tensors["position"].clone()
  p.step(g, visibility=torch.ones(4))
  q.step(g, visibility=torch.ones(4))
  torch.testing.assert_close(q.tensors["position"] - start,
                             5 * (p.tensors["position"] - start))
  assert q.update_groups(position=dict(lr=0.2)).learning_rates["position"] == \
      torch.tensor(0.2)


def test_state_dict_roundtrip():
  p = make_params(n=6)
  p.step({"position": torch.ones(6, 3)}, visibility=torch.ones(6))
  sd = p.state_dict()
  q = ParameterClass.from_state_dict(sd, device="cpu")
  torch.testing.assert_close(q.tensors["position"], p.tensors["position"],
                             rtol=0, atol=0)
  torch.testing.assert_close(q.state["position"].v, p.state["position"].v,
                             rtol=0, atol=0)
  assert q.group_dict == p.group_dict
  assert q.optimizer == p.optimizer
  q2 = pickle.loads(pickle.dumps(sd))
  assert set(q2["tensors"]) == set(sd["tensors"])


@pytest.mark.parametrize("pos_type", ["scalar", "local_vector"])
def test_step_span_counts_the_elements(pos_type):
  """A profiled CPU step is one span `tgr.optim.step` counting the
  elements of the groups it stepped (N * D: position 16 x 3, alpha 16 x
  1), none of them by the CUDA kernel; a group without a gradient is not
  counted."""
  p = make_params(n=16, pos_type=pos_type)
  kw = dict(basis=torch.eye(3).expand(16, 3, 3)) if pos_type == "local_vector" else {}
  tracing.clear()
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    p.step({"position": torch.ones(16, 3), "alpha": torch.ones(16, 1)},
           visibility=torch.ones(16), **kw)
    p.step({"position": torch.ones(16, 3)}, visibility=torch.ones(16), **kw)
  steps = [r for r in tracing.records() if r["name"] == "tgr.optim.step"]
  tracing.clear()
  assert [r["counts"] for r in steps] == [
      dict(elements=64, kernel_elements=0), dict(elements=48, kernel_elements=0)]
  assert all(r["parent"] is None and r["frame"] == r["id"] for r in steps)


def test_attribute_access():
  p = make_params(n=4)
  assert p.position.shape == (4, 3)
  assert p.aux.shape == (4,)
  with pytest.raises(AttributeError):
    _ = p.nonexistent


# -- parity with the JAX package ------------------------------------------

N_PARITY = 40


def _parity_inputs(seed, n_steps=5):
  rng = np.random.default_rng(seed)
  tensors = {"position": rng.normal(size=(N_PARITY, 2)),
             "alpha": rng.normal(size=(N_PARITY, 1))}
  steps = []
  for _ in range(n_steps):
    vis = rng.uniform(0.0, 3.0, size=N_PARITY) * (rng.uniform(size=N_PARITY) > 0.3)
    basis = rng.normal(size=(N_PARITY, 2, 2)) + 2 * np.eye(2)
    steps.append(dict(grads={k: rng.normal(size=v.shape) for k, v in tensors.items()},
                      vis=vis, basis=basis))
  return tensors, steps


@pytest.mark.parametrize("kernel", ["adam", "laprop"])
@pytest.mark.parametrize("visibility_aware", [False, True])
@pytest.mark.parametrize("kind", ["scalar", "vector", "local_vector"])
def test_step_matches_jax(kernel, visibility_aware, kind):
  """Five steps of the same gradients, visibility and basis through the
  JAX ParameterClass.step and the port's: parameters, moments and the
  shared state agree."""
  tensors, steps = _parity_inputs(7)
  groups = {"position": dict(lr=0.1, type=kind),
            "alpha": dict(lr=0.05, type="scalar")}
  jspec = jax_optim.OptimizerSpec(kernel=kernel, visibility_aware=visibility_aware)
  tspec = type(VisibilityAwareAdam)(kernel=kernel, visibility_aware=visibility_aware)
  jp = jax_optim.ParameterClass.create(
      {k: jnp.asarray(v) for k, v in tensors.items()}, groups, optimizer=jspec)
  tp = ParameterClass.create({k: torch.tensor(v) for k, v in tensors.items()},
                             groups, optimizer=tspec)
  for s in steps:
    kw = dict(basis=s["basis"]) if kind == "local_vector" else {}
    jp = jp.step({k: jnp.asarray(v) for k, v in s["grads"].items()},
                 visibility=jnp.asarray(s["vis"]),
                 **{k: jnp.asarray(v) for k, v in kw.items()})
    tp.step({k: torch.tensor(v) for k, v in s["grads"].items()},
            visibility=torch.tensor(s["vis"]),
            **{k: torch.tensor(v) for k, v in kw.items()})

  def close(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-12, err_msg=name)
  for k in tensors:
    close(tp.tensors[k], jp.tensors[k], k)
    close(tp.state[k].m, jp.state[k].m, f"{k}.m")
    close(tp.state[k].v, jp.state[k].v, f"{k}.v")
  close(tp.total_weight, jp.total_weight, "total_weight")
  close(tp.running_vis, jp.running_vis, "running_vis")
  assert not np.allclose(tp.tensors["position"].numpy(), tensors["position"])


@pytest.mark.parametrize("optimizer", ["FractionalAdam", "VisibilityAwareLaProp"])
def test_jax_state_dict_carries_into_the_port(optimizer):
  """A JAX state_dict(), unchanged, becomes a port ParameterClass with the
  same arrays, groups and spec, and both take the same next step."""
  tensors, steps = _parity_inputs(8, n_steps=3)
  groups = {"position": dict(lr=0.1, type="local_vector"),
            "alpha": dict(lr=0.05, type="scalar", betas=(0.8, 0.99))}
  jp = jax_optim.ParameterClass.create(
      {k: jnp.asarray(v) for k, v in tensors.items()}, groups,
      optimizer=getattr(jax_optim, optimizer))
  for s in steps[:2]:
    jp = jp.step({k: jnp.asarray(v) for k, v in s["grads"].items()},
                 visibility=jnp.asarray(s["vis"]), basis=jnp.asarray(s["basis"]))
  sd = jp.state_dict()
  tp = ParameterClass.from_state_dict(sd, device="cpu")
  assert tp.group_dict == {k: type(tp.group_dict[k])(**vars(v))
                           for k, v in jp.group_dict.items()}
  assert vars(tp.optimizer) == vars(jp.optimizer)
  for k in tensors:
    np.testing.assert_array_equal(tp.tensors[k].numpy(), sd["tensors"][k])
    np.testing.assert_array_equal(tp.state[k].m.numpy(), sd["state"][k]["m"])
    np.testing.assert_array_equal(tp.state[k].v.numpy(), sd["state"][k]["v"])
  np.testing.assert_array_equal(tp.total_weight.numpy(), sd["total_weight"])
  assert tp.learning_rates["alpha"].dtype == torch.float32

  s = steps[2]
  jp = jp.step({k: jnp.asarray(v) for k, v in s["grads"].items()},
               visibility=jnp.asarray(s["vis"]), basis=jnp.asarray(s["basis"]))
  tp.step({k: torch.tensor(v) for k, v in s["grads"].items()},
          visibility=torch.tensor(s["vis"]), basis=torch.tensor(s["basis"]))
  for k in tensors:
    np.testing.assert_allclose(tp.tensors[k].numpy(), np.asarray(jp.tensors[k]),
                               rtol=1e-6, atol=1e-12)
