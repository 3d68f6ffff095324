"""Projection and SH shading: the median CUDA-event ms of 20 calls of the
port's `project_to_image` followed by `evaluate_sh_at` on a frame's
camera, after warm-up (no autograd graph, as in serving)."""

import torch


def read(ctx):
  f, tgr = ctx.frame, ctx.tgr
  g, cam = f.gaussians, f.camera

  def project():
    with torch.no_grad():
      tgr.project_to_image(g, cam, f.config)
      if f.use_sh:
        tgr.evaluate_sh_at(g.feature, g.position, cam.camera_position)

  return ctx.dev.median_ms(project)
