"""Projection and SH shading, backward: the device ms a step of the
port's span `tgr.project.bwd` (from the end of the blend's backward to
the last gradient of the frame's Gaussians3D tensors: every autograd node
of SH and projection) in the traced steps, median over the steps."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("project.bwd")
