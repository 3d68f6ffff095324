"""Projection and SH shading, backward: the device ms a step of the
port's span `tgr.sh.bwd` (the SH kernel's autograd backward, inside
`tgr.project.bwd`) in the traced steps, median over the steps. Nothing to
read where the port has no such span."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("sh.bwd")
