"""Parallel: the device ms a step of NCCL kernels on rank 0 in the traced
sub-window (torch.profiler): the gradient all-reduce of `dp_train_step`
and the window's one-word stop vote."""


def read(ctx):
  p = ctx.profile
  if not p or p["nccl_ms_per_step"] <= 0:
    return None
  return p["nccl_ms_per_step"]
