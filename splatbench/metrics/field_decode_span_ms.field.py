"""Feature decoder: the device ms a step of the port's spans
`tgr.field.decode` and `tgr.field.decode.bwd` (the resize to the teacher's
size and the 1x1 convolution, forward and backward) in the traced steps,
median over the steps."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("field.decode", "field.decode.bwd")
