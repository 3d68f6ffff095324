"""Visual check of the 2D split operations: renders a few gaussians
before and after `split_gaussians2d` and `uniform_split_gaussians2d` side
by side and saves the strip as .npy (port of
`taichi_gaussian_rasterizer_tpu.examples.vis_split`).

Usage: python -m taichi_gaussian_rasterizer_tpu_torch.examples.vis_split
       [--device cuda|cpu] [--out vis_split.npy]
"""

import argparse

import numpy as np
import torch

from ..config import RasterConfig
from ..models.renderer2d import (render_gaussians, split_gaussians2d,
                                 uniform_split_gaussians2d)
from ..utils.random_data import random_2d_gaussians


def render(g, image_size, config):
  with torch.no_grad():
    return render_gaussians(g, image_size, config).image.cpu().numpy()


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--device", type=str, default="cuda")
  parser.add_argument("--out", type=str, default="vis_split.npy")
  parser.add_argument("--n", type=int, default=12)
  parser.add_argument("--size", type=int, default=256)
  args = parser.parse_args()

  device = torch.device(args.device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit(f"--device {args.device}: no CUDA device is available")

  image_size = (args.size, args.size)
  config = RasterConfig(tile_size=16)
  g = random_2d_gaussians(torch.Generator(device=device).manual_seed(0),
                          args.n, image_size, scale_factor=0.6,
                          alpha_range=(0.8, 0.95))

  def gen():
    return torch.Generator(device=device).manual_seed(1)

  panels = [
      render(g, image_size, config),
      render(split_gaussians2d(gen(), g, n=2), image_size, config),
      render(uniform_split_gaussians2d(gen(), g, n=3), image_size, config),
  ]
  strip = np.concatenate(panels, axis=1)
  np.save(args.out, strip)
  print(f"saved {strip.shape} panel strip (original | random split | "
        f"uniform split) to {args.out}")


if __name__ == "__main__":
  main()
