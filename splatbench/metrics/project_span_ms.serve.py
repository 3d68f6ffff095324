"""Projection and SH shading: the device ms a frame of the port's spans
`tgr.project` (`project_to_image`) and `tgr.sh` (`evaluate_sh_at`) in the
traced frames (their CUDA events), median over the frames."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("project", "sh")
