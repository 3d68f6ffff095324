"""Raster backward and reduction: the device ms a step of the port's span
`tgr.raster.bwd` (the blend's autograd backward: the backward kernel, the
reduction, the chain to the packed points) in the traced steps, median
over the steps."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("raster.bwd")
