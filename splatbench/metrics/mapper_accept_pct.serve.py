"""Tile mapper: the share of the candidate (tile, point) keys the mapper
sorts that its separating-axis test keeps, 100 · `overlaps` /
`candidates` of the port's span `tgr.map`, per traced frame, median over
the frames."""

from splatbench import spans


def read(ctx):
  return spans.count_ratio("map", "overlaps", "candidates")
