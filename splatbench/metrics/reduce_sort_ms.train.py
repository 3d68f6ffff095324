"""Raster backward and reduction: the device ms a step of the port's span
`tgr.reduce.sort` (the gradient reduction's stable sort of the slots by
point and the gather of the slot rows into that order) in the traced
steps, median over the steps."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("reduce.sort")
