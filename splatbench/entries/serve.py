"""`serve`: one viewer in a closed loop. Each frame is `render_gaussians`
of the next camera of the path, timed from the call to after
`torch.cuda.synchronize()`. Frames drawn from the seed are kept and
compared with the reference's render of the same view.

Measures: `mean_ms` (the whole window over the frames completed) and
`p95_ms` (the nearest-rank 95th percentile of every frame's time)."""

import time
from typing import Dict

import torch

from splatbench import harness, reference, runner, scenes, tracing


class Serve(runner.Entry):

  def setup(self):
    runner.load_kernels(self.tgr, self.dev)
    self.make_inputs()
    self.program = runner.to_gaussians(self.tgr, self.gaussians)
    with torch.no_grad():
      for view in range(len(self.cameras)):   # every view the window renders
        self.render(self.program, view)
    self.dev.sync()
    tr = self.traffic
    gen = torch.Generator().manual_seed(scenes.derive_seed(self.seed, 4))
    self.sample = sorted(set(torch.randperm(tr["check_within"], generator=gen)
                             [:tr["check_frames"]].tolist()))

  def window(self, seconds: float, trace: bool) -> Dict:
    tr, dev = self.traffic, self.dev
    views = len(self.cameras)
    kept, lat = {}, []
    traced = range(tr["trace_skip"], tr["trace_skip"] + tr["trace_frames"]) \
        if trace else range(0)
    prof = None
    start = time.perf_counter()
    i = 0
    with torch.no_grad():
      while True:
        if i == traced.start and trace:
          prof = tracing.profiler()
          prof.__enter__()
          rf = torch.profiler.record_function(tracing.WINDOW)
          rf.__enter__()
        f0 = time.perf_counter()
        r = self.render(self.program, i % views)
        dev.sync()
        ms = (time.perf_counter() - f0) * 1e3
        lat.append(ms)
        if i not in traced:
          self.frame_ms.append(ms)
        if i in self.sample:
          kept[i] = (r.image.clone(), r.image_weight.clone())
        if prof is not None and i == traced.stop - 1:
          rf.__exit__(None, None, None)
          prof.__exit__(None, None, None)
          self.profile = tracing.summarize(prof, len(traced))
          prof = None
        i += 1
        if time.perf_counter() - start >= seconds and i >= traced.stop:
          break
    window_s = time.perf_counter() - start
    last = i - 1
    for j in self.sample:
      if j not in kept:     # fewer frames than the sample reached: the last
        kept[last] = (r.image.clone(), r.image_weight.clone())
    self.kept = kept
    self.frames = i
    return dict(mean_ms=window_s * 1e3 / i, p95_ms=harness.quantile(lat, 0.95),
                attempted=i)

  def free(self):
    self.program = None

  def readings(self) -> Dict:
    return {j: v for j, v in self.kept.items()}

  def reference_readings(self, tf32: bool = False, half: bool = False) -> Dict:
    views = len(self.path)
    out = {}
    for j in self.kept:
      r = reference.render(self.gaussians, self.path[j % views], self.cfg, tf32)
      out[j] = (r["image"], r["weight"])
    return out

  def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
    worst = 0.0
    for j, (img_r, w_r) in ref.items():
      img_p, w_p = prog[j]
      diff = torch.cat([(img_p - img_r).abs().reshape(-1), (w_p - w_r).abs().reshape(-1)])
      scale = torch.cat([img_r.abs().reshape(-1), w_r.abs().reshape(-1)])
      worst = max(worst, float(diff.to(torch.float64).mean()
                               / scale.to(torch.float64).mean()))
    return {"frame_err": worst}


ENTRY = Serve
