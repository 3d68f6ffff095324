"""Optimizer: the share of its bound (`splatbench/optim_bounds.py`
`step_bound`: 28 bytes an element and 12 a point of the configuration's
gaussians over the HBM rate) that the port's span `tgr.optim.step` reaches:
the bound over the span's device ms, per traced step, median over the
steps. The bound is the configuration's, whatever implements the step."""

import statistics

from splatbench import optim_bounds, spans


def read(ctx):
  recs = spans.records()
  if recs is None:
    return None
  bound = optim_bounds.step_bound(ctx.entry.cfg)["ms"]
  ms = spans.per_frame(recs, ["optim.step"], lambda r: r["device_ms"])
  shares = [100.0 * bound / v for v in ms.values() if v > 0]
  return statistics.median(shares) if shares else None
