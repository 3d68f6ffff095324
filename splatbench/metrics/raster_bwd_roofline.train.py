"""Raster backward and reduction: the share of their bound that the port's
autograd backward of `rasterize_with_tiles` reaches on a frame of the
window's traffic (at the parameters the window left).

The bound is the frozen `backward_bound` plus `segment_sum_bound` on the
frame's active pairs (`splatbench/bounds.py`); the time is the median
CUDA-event ms of 20 calls of `torch.autograd.grad` of the frame's image
and weight, with a seeded cotangent, after warm-up: the backward kernel,
the reduction's sort, gather and segment sum, and the chain to the packed
points.
"""

import torch


def read(ctx):
  f, tgr = ctx.frame, ctx.tgr
  points = f.points.detach().requires_grad_()
  feats = f.feats.detach().requires_grad_()
  out = tgr.rasterize_with_tiles(points, feats, f.mapping, f.image_size, f.config)
  gen = torch.Generator(device=points.device).manual_seed(7)
  g_image = torch.randn(out.image.shape, generator=gen, device=points.device)
  g_weight = torch.randn(out.image_weight.shape, generator=gen, device=points.device)

  def backward():
    torch.autograd.grad([out.image, out.image_weight], [points, feats],
                        [g_image, g_weight], retain_graph=True)

  ms = ctx.dev.median_ms(backward)
  w, b = ctx.work, ctx.bounds
  n, f_, k = w["n_points"], w["n_features"], w["n_slots"]
  bound = (b.backward_bound(w, n, f_, k, w["n_tiles"], w["image_size"], False,
                            False, False)["ms"]
           + b.segment_sum_bound(b.backward_rows(f_), k, n)["ms"])
  return 100.0 * bound / ms
