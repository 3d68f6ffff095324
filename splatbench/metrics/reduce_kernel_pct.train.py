"""Raster backward and reduction: the share of the gradient reduction's
slot rows that its CUDA kernel reduced from the backward's slot-major
storage without a repack, 100 · `kernel_rows` / `rows` of the port's span
`tgr.reduce.sort` (the sort's span carries the counts), per traced step,
median over the steps. Nothing to read where the port's spans carry no
such counts."""

import statistics

from splatbench import spans


def read(ctx):
  recs = spans.records()
  if recs is None:
    return None
  sorts = [r for r in recs if r["name"] == "tgr.reduce.sort" and "rows" in r["counts"]]
  if not sorts or any("kernel_rows" not in r["counts"] for r in sorts):
    return None
  parts = spans.per_frame(sorts, ["reduce.sort"], lambda r: r["counts"]["kernel_rows"])
  wholes = spans.per_frame(sorts, ["reduce.sort"], lambda r: r["counts"]["rows"])
  shares = [100.0 * parts[f] / wholes[f] for f in wholes if wholes[f] > 0]
  return statistics.median(shares) if shares else None
