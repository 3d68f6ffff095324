"""Raster forward: the share of its bound that the port's public raster
entry reaches on a frame of the window's traffic.

The bound (`splatbench/bounds.py` `forward_bound`) comes from the frame's
active (pixel, slot) pairs as the reference counts them; the time is the
median CUDA-event ms of 20 calls of `rasterize_with_tiles` (forward only)
on the frame's projected points, features and mapping, after warm-up. A
share of the published H100 SXM peak (700 W); the card's power limit is
on the run's stderr.
"""

import torch


def read(ctx):
  f, tgr = ctx.frame, ctx.tgr

  def forward():
    with torch.no_grad():
      tgr.rasterize_with_tiles(f.points, f.feats, f.mapping, f.image_size, f.config)

  ms = ctx.dev.median_ms(forward)
  w = ctx.work
  b = ctx.bounds.forward_bound(w, w["n_points"], w["n_features"], w["n_slots"],
                               w["n_tiles"], w["image_size"], False)
  return 100.0 * b["ms"] / ms
