"""Projection and SH shading: the share of the rows `evaluate_sh_at`
shades that its CUDA kernel shades, 100 · `kernel_points` / `points` of
the port's span `tgr.sh`, per traced frame, median over the frames.
Nothing to read where the port's `tgr.sh` spans carry no such counts."""

from splatbench import spans


def read(ctx):
  recs = spans.records()
  if recs is None:
    return None
  shades = [r for r in recs if r["name"] == "tgr.sh"]
  if not shades or any("kernel_points" not in r["counts"] for r in shades):
    return None
  return spans.count_ratio("sh", "kernel_points", "points")
