"""Parallel: the device ms a step, on rank 0, of the port's span
`tgr.dp.pack` less its child `tgr.dp.allreduce` (its self time: the flat
buffer's cat and casts before the all-reduce, the split and casts after
it) in the traced steps, median over the steps."""

from splatbench import spans


def read(ctx):
  return spans.self_ms("dp.pack", "dp.allreduce")
