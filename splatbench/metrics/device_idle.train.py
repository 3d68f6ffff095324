"""Device: the share of the traced sub-window in which no kernel, memcpy
or memset ran on the card (rank 0's on several cards): 1 - (the union of
the device intervals torch.profiler records) / (the sub-window's length)."""


def read(ctx):
  p = ctx.profile
  if not p or p["window_s"] <= 0:
    return None
  return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
