"""Tile mapper: the host ms a frame spent in the port's span
`tgr.map.sync`, the mapper's one host sync (the candidate total), in the
traced frames, median over the frames: how long the host waits there for
the work it has queued."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("map.sync", field="host_ms")
