"""Optimizer: the device ms a step of the port's span `tgr.optim.step`
(`ParameterClass.step`) in the traced steps, median over the steps."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("optim.step")
