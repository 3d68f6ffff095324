"""Optimizer: the median CUDA-event ms of the benchmark's own span around
`ParameterClass.step` in the traced steps of the window."""


def read(ctx):
  spans = ctx.spans.get("optim")
  if not spans:
    return None
  s = sorted(spans)
  return s[(len(s) - 1) // 2]
