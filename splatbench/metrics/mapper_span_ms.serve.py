"""Tile mapper: the device ms a frame of the port's span `tgr.map`
(`map_to_tiles`, its host sync inside) in the traced frames, median over
the frames."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("map")
