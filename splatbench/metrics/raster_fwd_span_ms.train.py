"""Raster forward in a training step: the device ms a step of the port's
span `tgr.raster.fwd` (the blend's autograd forward; in the Feature 3DGS
cell the SH colour and the semantic features blended in one pass) in the
traced steps, median over the steps."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("raster.fwd")
