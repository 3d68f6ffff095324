"""Raster forward: the device ms a frame of the port's span `tgr.raster.fwd`
(the blend's autograd forward) in the traced frames, median over the
frames."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("raster.fwd")
