"""`train`: one camera a step. `render_gaussians`, the configuration's
loss (`splatbench/losses/<loss>.py`) against the view's seeded target,
`loss.backward()`, then `ParameterClass.step` with FractionalAdam and unit
weights. The first three steps, run in set-up through the window's own
step, are compared: their losses, the first gradient as the optimizer
holds it (its first moment after one step over 1 - beta1) and the
parameters' change after three (`train_numbers`, PERF.md §2).

Measures: `step_ms` (the whole window, closed by a synchronize, over the
steps completed); the run adds `peak_gib`."""

import time
from typing import Dict

import torch

from splatbench import harness, reference, runner, scenes, tracing

BETA1 = 0.9   # the port's GroupConfig default, which the cells use


class Train(runner.Entry):

  trains = True   # readings.py plants the half-batch fault in its reference

  def setup(self):
    runner.load_kernels(self.tgr, self.dev)
    self.make_inputs()
    self.lrs = runner.learning_rates(self.cfg, self.median_depth)
    self.prepare()
    self.gaussians = None   # the program updates these tensors in place
    tr = self.traffic
    self.losses = []
    for i in range(tr["warm_steps"]):
      loss = self.step(i)
      if i < tr["checked_steps"]:
        self.losses.append(float(loss))
      if i == 0:
        self.g1 = {k: (s.m / (1.0 - BETA1)).cpu() for k, s in self.params.state.items()}
      if i == tr["checked_steps"] - 1:
        self.after = {k: v.detach().cpu().clone() for k, v in self.params.tensors.items()}
    self.dev.sync()
    self.next_step = tr["warm_steps"]

  def prepare(self):
    """The loss, the targets and the program's parameters."""
    from taichi_gaussian_rasterizer_tpu_torch.optim import (FractionalAdam,
                                                            ParameterClass)
    self.loss = harness.load_part("losses", self.cfg["loss"], self.cell.root)
    self.targets = [runner.make_target(self.cfg, self.target_channels(), self.seed,
                                       t, self.dev.device)
                    for t in range(self.traffic["targets"])]
    self.params = ParameterClass.create(
        dict(self.gaussians), {k: {"lr": v} for k, v in self.lrs.items()},
        optimizer=FractionalAdam)
    self.ones = torch.ones(self.params.num_points, dtype=torch.float32,
                           device=self.dev.device)

  def target_channels(self) -> int:
    """The image's channels the loss compares, and those the loss adds
    (a rendered depth)."""
    feat = self.cfg["features"]
    return (3 if feat["kind"] == "sh" else feat["channels"]) + self.loss.EXTRA_CHANNELS

  def view(self, i: int) -> int:
    return i % len(self.cameras)

  def target(self, view: int):
    return self.targets[view % len(self.targets)]

  def step(self, i: int, span=None):
    v = self.view(i)
    leaves = {k: self.params.tensors[k].detach().requires_grad_()
              for k in scenes.GAUSSIAN_KEYS}
    r = self.render(self.tgr.Gaussians3D(**leaves), v)
    loss = self.loss.loss(r.image, r.depth, self.target(v))
    loss.backward()
    if span is not None:
      span.start()
    self.params.step({k: leaves[k].grad for k in scenes.GAUSSIAN_KEYS},
                     weight=self.ones)
    if span is not None:
      self.spans.setdefault("optim", []).append(span.stop())
    return loss.detach()

  def begin_window(self):
    pass

  def stop(self, done: bool) -> bool:
    return done

  def window(self, seconds: float, trace: bool) -> Dict:
    tr, dev = self.traffic, self.dev
    traced = range(tr["trace_skip"], tr["trace_skip"] + tr["trace_steps"]) \
        if trace else range(0)
    prof = None
    self.begin_window()
    start = time.perf_counter()
    n = 0
    while True:
      if trace and n == traced.start:
        dev.sync()
        prof = tracing.profiler()
        prof.__enter__()
        rf = torch.profiler.record_function(tracing.WINDOW)
        rf.__enter__()
        t_untraced = time.perf_counter() - start
      self.step(self.next_step, dev.span() if n in traced else None)
      self.next_step += 1
      n += 1
      if prof is not None and n == traced.stop:
        dev.sync()
        rf.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        self.profile = tracing.summarize(prof, len(traced))
        prof = None
        self.traced_s = time.perf_counter() - start - t_untraced
      if self.stop(time.perf_counter() - start >= seconds and n >= traced.stop):
        break
    dev.sync()
    window_s = time.perf_counter() - start
    untraced_s = window_s - (self.traced_s if trace else 0.0)
    self.frame_ms = [untraced_s * 1e3 / max(n - len(traced), 1)]
    return dict(step_ms=window_s * 1e3 / n, attempted=n)

  def free(self):
    self.params = None
    self.ones = None

  def readings(self) -> Dict:
    return dict(losses=self.losses, g1=self.g1, after=self.after)

  def reference_readings(self, tf32: bool = False, half: bool = False) -> Dict:
    """The reference's first three steps from the seeded scene: with
    `half`, each step's loss is taken over the image's top half only (a
    fault planted in the reference)."""
    _, init = scenes.make_scene(self.cfg, self.seed, self.dev.device,
                                self.cell.root)
    opt = reference.FractionalAdam(init, self.lrs)
    losses, g1 = [], None
    for i in range(self.traffic["checked_steps"]):
      v = self.view(i)
      loss, grads = reference.loss_and_grads(
          opt.params, self.path[v], self.cfg, self.loss.loss, self.target(v), tf32,
          rows=_half_rows(self.cfg) if half else None)
      losses.append(float(loss))
      if i == 0:
        g1 = {k: g.reshape(g.shape[0], -1) for k, g in grads.items()}
      opt.step(grads)
    return dict(losses=losses, g1=g1, after=opt.params, init=init)

  def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
    return train_numbers(prog, ref)

  def detail(self, prog: Dict, ref: Dict) -> Dict:
    """Where the numbers' readings come from: the losses of each step and,
    per leaf, the first gradient's and the change's gaps."""
    init = ref["init"]
    out = dict(losses=[prog["losses"], ref["losses"]],
               change_leaves=leaf_detail(
                   {k: prog["after"][k].to(init[k].device) - init[k] for k in init},
                   {k: ref["after"][k] - init[k] for k in init}))
    if prog.get("g1") is not None and ref.get("g1") is not None:
      out["g1_leaves"] = leaf_detail(prog["g1"], ref["g1"])
    return out


def _half_rows(cfg: Dict) -> slice:
  return slice(0, cfg["image_size"][1] // 2)


def leaf_detail(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
  """Per leaf: the gap of norms and the norm of the difference over the
  reference's norm, and the share of the squared difference that its ten
  worst points hold (readings only: where a number's reading comes from)."""
  out = {}
  for k, r in ref.items():
    p = prog[k].to(r.device).reshape(r.shape)
    d = (p - r).to(torch.float64).reshape(r.shape[0], -1)
    rows = (d * d).sum(1)
    total = float(rows.sum())
    top = float(torch.topk(rows, min(10, rows.shape[0])).values.sum())
    n = max(_norm(r), 1e-30)
    out[k] = dict(norm=n, gap=abs(_norm(p) - n) / n, err=_norm(d) / n,
                  top10_share=top / total if total > 0 else 0.0)
  return out


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
  """The training check's numbers (see PERF.md §2): each step's loss, the
  first gradient and the change after the checked steps, by the worst
  leaf."""
  gaps = [abs(p - r) / max(abs(r), 1e-30)
          for p, r in zip(prog["losses"], ref["losses"])]
  g1r = ref["g1"]
  norms = {k: _norm(v) for k, v in g1r.items()}
  median = sorted(norms.values())[len(norms) // 2]
  moving = [k for k in g1r if norms[k] >= 1e-3 * median]
  init = ref["init"]
  d_ref = {k: (ref["after"][k] - init[k]).reshape(init[k].shape[0], -1)
           for k in moving}
  d_prog = {k: (prog["after"][k].to(init[k].device) - init[k]).reshape(
      init[k].shape[0], -1) for k in moving}
  g1p = {k: prog["g1"][k].reshape(g1r[k].shape) for k in g1r}
  return dict(loss_gap=max(gaps), loss_gap_first=gaps[0],
              grad_gap=leaf_gaps(g1p, g1r, diff=False),
              grad_err=leaf_gaps(g1p, g1r, diff=True),
              change_gap=leaf_gaps(d_prog, d_ref, diff=False))


def _norm(x: torch.Tensor) -> float:
  return float(torch.linalg.vector_norm(x.to(torch.float64)))


def leaf_gaps(prog: Dict, ref: Dict, diff: bool) -> float:
  """The worst leaf's gap: |‖p‖ - ‖r‖| (diff False) or ‖p - r‖ (diff
  True), over the larger of the reference's norm of that leaf and of the
  median leaf."""
  norms = {k: _norm(ref[k]) for k in ref}
  median = sorted(norms.values())[len(norms) // 2]
  worst = 0.0
  for k, r in ref.items():
    p = prog[k].to(r.device)
    gap = _norm(p - r) if diff else abs(_norm(p) - norms[k])
    worst = max(worst, gap / max(norms[k], median, 1e-30))
  return worst


ENTRY = Train
