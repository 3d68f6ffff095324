"""Parallel: the device ms a step, on rank 0, of the port's span
`tgr.dp.allreduce` (the one `dist.all_reduce` of the flat gradient
buffer in `dp_train_step`, on the current stream: from the buffer being
ready to the collective done, the wait for the slowest rank included) in
the traced steps, median over the steps."""

from splatbench import spans


def read(ctx):
  return spans.median_ms("dp.allreduce")
