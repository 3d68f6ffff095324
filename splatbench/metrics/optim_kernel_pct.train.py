"""Optimizer: the share of the elements `ParameterClass.step` steps that
its CUDA kernel steps, 100 · `kernel_elements` / `elements` of the port's
span `tgr.optim.step`, per traced step, median over the steps. Nothing to
read where the port's `tgr.optim.step` spans carry no such counts."""

from splatbench import spans


def read(ctx):
  recs = spans.records()
  if recs is None:
    return None
  steps = [r for r in recs if r["name"] == "tgr.optim.step"]
  if not steps or any("kernel_elements" not in r["counts"] for r in steps):
    return None
  return spans.count_ratio("optim.step", "kernel_elements", "elements")
