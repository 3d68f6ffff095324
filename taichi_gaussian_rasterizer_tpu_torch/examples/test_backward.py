"""Forward and backward smoke run: renders a random 2D scene, takes the
gradient of sum(image^2) a few times, and prints timings and gradient
norms (port of `taichi_gaussian_rasterizer_tpu.examples.test_backward`).

Usage: python -m taichi_gaussian_rasterizer_tpu_torch.examples.test_backward
       [--device cuda|cpu] [--n 10000] [--size 512] [--tile_size 16]
"""

import argparse
import time

import torch

from ..config import RasterConfig
from ..models.renderer2d import project_gaussians2d
from ..ops.raster import rasterize
from ..utils.random_data import random_2d_gaussians


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--device", type=str, default="cuda")
  parser.add_argument("--n", type=int, default=10_000)
  parser.add_argument("--size", type=int, default=512)
  parser.add_argument("--tile_size", type=int, default=16)
  parser.add_argument("--antialias", action="store_true")
  parser.add_argument("--iters", type=int, default=10)
  args = parser.parse_args()

  device = torch.device(args.device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit(f"--device {args.device}: no CUDA device is available")

  def sync():
    if device.type == "cuda":
      torch.cuda.synchronize(device)

  image_size = (args.size, args.size)
  config = RasterConfig(tile_size=args.tile_size, antialias=args.antialias)
  g = random_2d_gaussians(torch.Generator(device=device).manual_seed(0),
                          args.n, image_size)
  points = project_gaussians2d(g)
  depth = torch.clamp(g.z_depth.reshape(-1), 0, 1)

  def fwd_bwd():
    p = points.detach().requires_grad_()
    f = g.feature.detach().requires_grad_()
    loss = torch.sum(rasterize(p, depth, f, image_size, config).image ** 2)
    gp, gf = torch.autograd.grad(loss, [p, f])
    return float(loss.detach()), gp, gf

  t0 = time.perf_counter()
  loss, gp, gf = fwd_bwd()
  sync()
  print(f"first run (kernel build included): {time.perf_counter() - t0:.2f}s "
        f"loss={loss:.4f}")

  t0 = time.perf_counter()
  for _ in range(args.iters):
    loss, gp, gf = fwd_bwd()
  sync()
  print(f"fwd+bwd: {(time.perf_counter() - t0) / args.iters * 1000:.2f} ms/iter")
  print(f"grad norms: points={float(gp.norm()):.4f} "
        f"features={float(gf.norm()):.4f}")


if __name__ == "__main__":
  main()
