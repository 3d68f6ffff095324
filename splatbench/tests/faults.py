"""Faults planted in the port underneath a run (the timed path broken),
as hooks that run in the process that renders: in the test's own process
for one-card cells, in each rank's process for the several-card one."""

import os


def answer_altered():
  """Every rendered image comes back with one block of pixels changed."""
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  original = tgr.render_gaussians

  def broken(*args, **kwargs):
    r = original(*args, **kwargs)
    image = r.image.clone()
    image[:16, :16] += 0.25
    return r.replace(image=image)

  tgr.render_gaussians = broken


def state_unchanged():
  """The optimizer step returns its state as it was."""
  from taichi_gaussian_rasterizer_tpu_torch.optim import ParameterClass
  ParameterClass.step = lambda self, *a, **k: self


def half_batch():
  """Half of each step's batch is left out: on one card the lower half of
  the image passes no gradient; on several, the upper half of the ranks'
  cameras pass none."""
  from taichi_gaussian_rasterizer_tpu_torch.models import renderer
  original = renderer.rasterize_with_tiles
  world = int(os.environ.get("WORLD_SIZE", "1"))

  def broken(*args, **kwargs):
    out = original(*args, **kwargs)
    if world > 1:
      if int(os.environ["RANK"]) < world // 2:
        return out
      return out._replace(image=out.image.detach(),
                          image_weight=out.image_weight.detach())
    h = out.image.shape[0] // 2
    image = out.image.clone()
    image[h:] = image[h:].detach()
    return out._replace(image=image)

  renderer.rasterize_with_tiles = broken


def exchange_left_out():
  """The data-parallel step's all-reduce does nothing: each rank steps
  with its own gradient."""
  from taichi_gaussian_rasterizer_tpu_torch.parallel import sharding

  def local(tensors, mesh):
    return [t.detach().clone() for t in tensors]

  sharding._all_reduce_flat = local


def lr_off():
  """One group's learning rate off by 10%: the feature group's (the SH
  coefficients, whose change leads the median leaf's) steps at 1.1 times
  its rate."""
  from taichi_gaussian_rasterizer_tpu_torch.optim import ParameterClass
  original = ParameterClass.create

  def broken(tensors, parameter_groups, *args, **kwargs):
    groups = {k: dict(v) for k, v in parameter_groups.items()}
    groups["feature"]["lr"] *= 1.1
    return original(tensors, groups, *args, **kwargs)

  ParameterClass.create = staticmethod(broken)
