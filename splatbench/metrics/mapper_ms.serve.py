"""Tile mapper: the median CUDA-event ms of 20 calls of the port's
`map_to_tiles` on a frame's projected points and NDC depths, after
warm-up. Its one host sync (the candidate count) is inside the time."""


def read(ctx):
  f, tgr = ctx.frame, ctx.tgr
  return ctx.dev.median_ms(
      lambda: tgr.map_to_tiles(f.points, f.ndc, f.image_size, f.config))
