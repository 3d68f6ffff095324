"""`dp_train`: the `train` entry on `ranks` cards through the port's
`dp_train_step`: one camera a rank a step, one gradient all-reduce a step,
one process a card (`runner.run_dp`). Rank r takes view (ranks * step + r)
of the path each step. Besides the training numbers, every rank's
parameters after the checked steps are held against rank 0's
(`rank_spread`).

Measures: `step_ms`, a world step (rank 0's window from the ranks'
barrier); the run adds `peak_gib`, the largest over the ranks."""

import time
from pathlib import Path
from typing import Dict

import torch

from splatbench import harness, reference, runner, scenes

Train = harness.load_part("entries", "train", Path(__file__).resolve().parents[2]).Train


class DpTrain(Train):
  """One rank of `dp_train`: rank r takes view (ranks * step + r) of the
  path each step, through the port's `dp_train_step`."""

  def prepare(self):
    from taichi_gaussian_rasterizer_tpu_torch import parallel
    from taichi_gaussian_rasterizer_tpu_torch.optim import (FractionalAdam,
                                                            ParameterClass)
    self.mesh = parallel.make_mesh(device=self.dev.device)
    self.ranks = self.mesh.size
    # dp_train_step's loss
    self.loss = harness.load_part("losses", "mse", self.cell.root)
    views = len(self.cameras)
    self.targets = {v: runner.make_target(self.cfg, self.target_channels(), self.seed,
                                          v % self.traffic["targets"], self.dev.device)
                    for v in range(self.rank, views, self.ranks)}
    self.params = ParameterClass.create(
        dict(self.gaussians), {k: {"lr": v} for k, v in self.lrs.items()},
        optimizer=FractionalAdam)
    cam = self.camera
    self.dp_step = parallel.dp_train_step(
        self.mesh, self.config, tuple(cam["image_size"]), local_batch=1,
        use_sh=self.use_sh, depth_range=(cam["near_plane"], cam["far_plane"]))

  def view(self, i: int) -> int:
    return (self.ranks * i + self.rank) % len(self.cameras)

  def target(self, view: int):
    return self.targets[view]

  def step(self, i: int, span=None):
    v = self.view(i)
    cam = self.cameras[v]
    _, loss = self.dp_step(self.params, cam.projection[None],
                           cam.T_camera_world[None], self.target(v)[None])
    return loss

  def begin_window(self):
    import torch.distributed as dist
    dist.barrier(device_ids=[self.dev.device.index] if self.dev.cuda else None)
    self.window_start = time.time()

  def stop(self, done: bool) -> bool:
    """Every rank stops after the same step: the latest clock decides."""
    import torch.distributed as dist
    flag = torch.tensor([int(done)], dtype=torch.int32, device=self.dev.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag)

  def free(self):
    self.params = None
    self.dp_step = None

  def reference_readings(self, tf32: bool = False, half: bool = False) -> Dict:
    """The reference's first world steps: each rank the gradient of its own
    view, averaged over the ranks by the reference's own all-reduce, then
    FractionalAdam on every rank. With `half`, the ranks of the upper half
    of the world contribute nothing (the fault: half of the batch left
    out, the mean taken over the rest)."""
    import torch.distributed as dist
    _, init = scenes.make_scene(self.cfg, self.seed, self.dev.device,
                                self.cell.root)
    opt = reference.FractionalAdam(init, self.lrs)
    losses, g1 = [], None
    kept = self.ranks // 2 if half else self.ranks
    for i in range(self.traffic["checked_steps"]):
      v = self.view(i)
      loss, grads = reference.loss_and_grads(opt.params, self.path[v], self.cfg,
                                             self.loss.loss, self.target(v), tf32)
      scale = 1.0 / kept if self.rank < kept else 0.0
      parts = [loss.reshape(1)] + [grads[k].reshape(-1) for k in scenes.GAUSSIAN_KEYS]
      flat = torch.cat(parts) * scale
      dist.all_reduce(flat)
      loss, off = float(flat[0]), 1
      for k in scenes.GAUSSIAN_KEYS:
        n = grads[k].numel()
        grads[k] = flat[off:off + n].view(grads[k].shape)
        off += n
      losses.append(loss)
      if i == 0:
        g1 = {k: g.reshape(g.shape[0], -1).clone() for k, g in grads.items()}
      opt.step(grads)
    return dict(losses=losses, g1=g1, after=opt.params, init=init)

  def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training numbers on this rank, and how far this rank's
    parameters after the checked steps lie from rank 0's (0: every rank
    applied the same values)."""
    import torch.distributed as dist
    numbers = super().compare(prog, ref)
    spread = 0.0
    for k, v in prog["after"].items():
      mine = v.to(self.dev.device)
      theirs = mine.clone()
      dist.broadcast(theirs, src=0)
      spread = max(spread, float((mine - theirs).abs().max()))
    numbers["rank_spread"] = spread
    return numbers


ENTRY = DpTrain
