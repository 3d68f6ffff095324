"""2D gaussian image fitting, the end-to-end training example (port of
`taichi_gaussian_rasterizer_tpu.examples.fit_image_gaussians`).

Fits a target image with 2D gaussians by gradient descent and grows the
point count with split/prune between epochs, driven by the backward
pass's heuristics. Each epoch is a Python loop of steps at a fixed point
count (the JAX code's `lax.scan`); every step runs project ->
map_to_tiles -> rasterize_with_tiles (heuristic and visibility sinks) ->
sigmoid -> MSE and regularisers -> autograd -> the visibility-aware
optimizer step. On the card a step launches each of the three raster
kernels once; on the CPU it runs their plain versions.

Run:  python -m taichi_gaussian_rasterizer_tpu_torch.examples.fit_image_gaussians
      [--device cuda|cpu] [--image img.npy] [--n 1000] [--target 20000]
      [--iters 2000]
"""

import argparse
import math
import statistics
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import RasterConfig
from ..data_types import Gaussians2D
from ..models.renderer2d import (point_basis, project_gaussians2d,
                                 uniform_split_gaussians2d)
from ..ops.mapper import map_to_tiles
from ..ops.raster import rasterize_with_tiles
from ..optim import ParameterClass, VisibilityAwareLaProp
from ..utils.random_data import random_2d_gaussians

TENSOR_KEYS = ("position", "z_depth", "log_scaling", "rotation",
               "alpha_logit", "feature")


def gaussians_to_tensors(g: Gaussians2D):
  return {k: getattr(g, k) for k in TENSOR_KEYS}


def tensors_to_gaussians(t) -> Gaussians2D:
  return Gaussians2D(**{k: t[k] for k in TENSOR_KEYS})


def psnr(a, b):
  """CPSNR of two images in [0, 1]."""
  return 10 * torch.log10(1.0 / torch.mean((a - b) ** 2))


def log_lerp(t, a, b):
  """Geometric interpolation (the learning-rate schedule)."""
  return math.exp(math.log(a) * (1 - t) + math.log(b) * t)


def make_epochs(total_iters: int, first_epoch: int, max_epoch: int):
  """Growing epoch schedule."""
  iteration, epochs = 0, []
  while iteration < total_iters:
    t = iteration / total_iters
    size = math.ceil(log_lerp(t, first_epoch, max_epoch))
    if iteration + size * 2 > total_iters:
      size = total_iters - iteration
    iteration += size
    epochs.append(size)
  return epochs


def take_n(t: torch.Tensor, n: int, descending=False) -> torch.Tensor:
  """Mask of the n smallest (or largest) values, on t's device.

  The sort is stable, so tied values are taken in index order. The JAX
  code uses numpy's unstable `argsort`, so on tied scores the two may
  pick different points."""
  order = torch.argsort(-t if descending else t, stable=True)[:n]
  mask = torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
  mask[order] = True
  return mask


def find_split_prune(n, target, n_prune, prune_cost, split_score):
  """(split mask, prune mask). Points in both masks drop out of both,
  which realizes exactly `target` while there are enough points to
  split: n + (target_split - both) - (n_prune - both) == target."""
  prune_mask = take_n(prune_cost, n_prune, descending=False)
  target_split = max(0, (target - n) + int(prune_mask.sum()))
  split_mask = take_n(split_score, target_split, descending=True)
  both = split_mask & prune_mask
  return split_mask ^ both, prune_mask ^ both


def split_prune(generator: torch.Generator, params: ParameterClass, t, target,
                prune_rate, heuristics: torch.Tensor):
  """Prune the lowest prune-cost points and split the highest
  split-score points toward the target count."""
  n = params.num_points
  split_mask, prune_mask = find_split_prune(
      n=n, target=target, n_prune=int(prune_rate * n * (1 - t)),
      prune_cost=heuristics[:, 0], split_score=heuristics[:, 1])

  to_split = params[split_mask]
  splits = uniform_split_gaussians2d(
      generator, tensors_to_gaussians(to_split.tensors), random_axis=True)

  params = params[~(split_mask | prune_mask)]
  params = params.append_tensors(gaussians_to_tensors(splits))
  return params, dict(split=int(split_mask.sum()),
                      prune=int(prune_mask.sum()))


def _synchronize(device: torch.device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def train_epoch(params: ParameterClass, ref_image: torch.Tensor,
                image_size: Tuple[int, int], config: RasterConfig,
                epoch_size: int = 100, opacity_reg: float = 0.0,
                scale_reg: float = 0.0,
                step_ms: Optional[List[float]] = None):
  """One epoch of fitting at a fixed point count, `params` stepped in
  place.

  Returns (params, the last step's rendered image, heuristics (N, 2)
  summed over the steps, the last step's visibility (N,), mean loss, and
  whether any step's tile mapping clamped a footprint). With `step_ms` a
  list, each step's host-clock time, ending in a device synchronise, is
  appended to it.
  """
  n = params.num_points
  w, h = image_size
  dtype = params.tensors["position"].dtype
  device = params.device
  heur_acc = torch.zeros((n, 2), dtype=dtype, device=device)
  losses = []
  overflow = torch.zeros((), dtype=torch.bool, device=device)

  for _ in range(epoch_size):
    t0 = time.perf_counter()
    leaves = {k: params.tensors[k].detach().requires_grad_() for k in TENSOR_KEYS}
    sink = torch.zeros((n, 2), dtype=dtype, device=device, requires_grad=True)
    vsink = torch.zeros((n,), dtype=dtype, device=device, requires_grad=True)

    g = tensors_to_gaussians(leaves)
    packed = project_gaussians2d(g)
    mapping = map_to_tiles(packed.detach(),
                           torch.clamp(g.z_depth.detach().reshape(-1), 0.0, 1.0),
                           image_size, config)
    # visibility arrives as vsink's gradient: it rides the backward's
    # reduction, and the forward skips its visibility output
    out = rasterize_with_tiles(packed, g.feature, mapping, image_size, config,
                               heuristic_sink=sink, visibility_sink=vsink)
    image = torch.sigmoid(out.image)
    scale = torch.exp(g.log_scaling) / min(w, h)
    loss = (torch.mean((image - ref_image) ** 2)
            + opacity_reg * torch.mean(torch.sigmoid(g.alpha_logit))
            + scale_reg * torch.mean(scale ** 2))

    *grads, heur, vis = torch.autograd.grad(
        loss, [*leaves.values(), sink, vsink], materialize_grads=True)
    grads = dict(zip(TENSOR_KEYS, grads))

    with torch.no_grad():
      basis = point_basis(tensors_to_gaussians(params.tensors))
      params.step(grads, visibility=vis, basis=basis)
      # parameter clamps
      rot = params.tensors["rotation"]
      rot /= torch.linalg.vector_norm(rot, dim=1, keepdim=True)
      params.tensors["log_scaling"].clamp_(-5, 5)
      heur_acc += heur
      overflow |= mapping.overflow
    losses.append(loss.detach())
    if step_ms is not None:
      _synchronize(device)
      step_ms.append((time.perf_counter() - t0) * 1e3)

  return (params, image.detach(), heur_acc, vis, torch.stack(losses).mean(),
          overflow)


def make_parameter_class(gaussians: Gaussians2D, base_lr: float = 0.1,
                         optimizer=VisibilityAwareLaProp) -> ParameterClass:
  """Per-attribute groups; position steps in the point-local basis."""
  groups = {
      "position": dict(lr=base_lr, type="local_vector"),
      "z_depth": dict(lr=base_lr * 0.01, type="scalar"),
      "log_scaling": dict(lr=base_lr * 0.2, type="scalar"),
      "rotation": dict(lr=base_lr * 1.0, type="scalar"),
      "alpha_logit": dict(lr=base_lr * 1.0, type="scalar"),
      "feature": dict(lr=base_lr * 0.5, type="scalar"),
  }
  return ParameterClass.create(gaussians_to_tensors(gaussians), groups,
                               optimizer=optimizer)


def synthetic_target(image_size: Tuple[int, int], device="cuda") -> torch.Tensor:
  """Procedural (H, W, 3) float32 target: a smooth colour field and two
  hard-edged shapes for the split heuristic to chase."""
  w, h = image_size
  ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device),
                          indexing="ij")
  xs, ys = xs / w, ys / h
  r = 0.5 + 0.5 * torch.sin(3 * xs + 1.3) * torch.cos(2 * ys)
  g = 0.5 + 0.5 * torch.cos(4 * xs * ys * 6.28)
  b = torch.clamp(1.3 * ((xs - 0.5) ** 2 + (ys - 0.5) ** 2) ** 0.5, 0, 1)
  img = torch.stack([r, g, b], dim=-1)
  disc = ((xs - 0.3) ** 2 + (ys - 0.35) ** 2) < 0.03
  square = ((xs - 0.7).abs() < 0.12) & ((ys - 0.65).abs() < 0.15)
  img = torch.where(disc[..., None], img.new_tensor([0.95, 0.2, 0.1]), img)
  img = torch.where(square[..., None], img.new_tensor([0.1, 0.3, 0.9]), img)
  return img.to(torch.float32)


def load_image(path: str) -> np.ndarray:
  if path.endswith(".npy"):
    img = np.load(path)
  else:
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
  return (img / 255.0 if img.dtype == np.uint8 else img).astype(np.float32)


def fit(ref_image: torch.Tensor, n: int = 1000, target: Optional[int] = None,
        total_iters: int = 2000, base_lr: float = 0.1,
        prune_rate: float = 0.05, opacity_reg: float = 0.0,
        scale_reg: float = 0.0,
        config: RasterConfig = RasterConfig(compute_point_heuristic=True),
        seed: int = 0, device=None, log=print,
        history: Optional[list] = None):
  """The full training loop on `device` (default: the target's device).

  The target moves to `device`, the gaussians are made there from a
  generator seeded with `seed`. With `history` a list, each epoch's
  metrics are appended to it as a dict (n, psnr, loss, ms_step_median,
  and split and prune counts between epochs). Returns (params, the last
  rendered image)."""
  device = torch.device(device) if device is not None else ref_image.device
  ref_image = ref_image.to(device)
  h, w = ref_image.shape[:2]
  image_size = (w, h)
  target = target or n

  gen = torch.Generator(device=device).manual_seed(seed)
  gaussians = random_2d_gaussians(gen, n, image_size, alpha_range=(0.7, 0.9))
  params = make_parameter_class(gaussians, base_lr)

  iteration = 0
  image = None
  for i, epoch_size in enumerate(make_epochs(total_iters, 10, 100)):
    t = iteration / total_iters
    params = params.set_learning_rate(position=log_lerp(t, base_lr, base_lr * 0.1))

    step_ms = []
    params, image, heuristics, vis, loss, overflow = train_epoch(
        params, ref_image, image_size, config, epoch_size=epoch_size,
        opacity_reg=opacity_reg, scale_reg=scale_reg, step_ms=step_ms)
    if bool(overflow):
      log(f"WARNING: a footprint exceeded max_tile_span in epoch {i} and was "
          "clamped; raise RasterConfig.max_tile_span")
    iteration += epoch_size

    metrics = dict(n=params.num_points,
                   psnr=float(psnr(image, ref_image)),
                   loss=float(loss),
                   ms_step_median=statistics.median(step_ms))

    if iteration < total_iters:
      params, counts = split_prune(gen, params, t, target, prune_rate,
                                   heuristics)
      metrics.update(counts)

    if history is not None:
      history.append(metrics)
    log(f"epoch {i} (iter {iteration}): " +
        " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in metrics.items()))

  return params, image


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--device", type=str, default="cuda",
                      help="torch device; a CUDA device must be present when "
                           "asked for (default cuda)")
  parser.add_argument("--image", type=str, default=None,
                      help="target image (png/npy); default synthetic")
  parser.add_argument("--width", type=int, default=512)
  parser.add_argument("--height", type=int, default=384)
  parser.add_argument("--n", type=int, default=1000)
  parser.add_argument("--target", type=int, default=None)
  parser.add_argument("--iters", type=int, default=2000)
  parser.add_argument("--lr", type=float, default=0.1)
  parser.add_argument("--tile_size", type=int, default=16)
  parser.add_argument("--prune_rate", type=float, default=0.05)
  parser.add_argument("--opacity_reg", type=float, default=0.0)
  parser.add_argument("--scale_reg", type=float, default=0.0)
  parser.add_argument("--antialias", action="store_true")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--save", type=str, default=None,
                      help="save final render to .npy")
  args = parser.parse_args()

  device = torch.device(args.device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run the plain versions)")

  if args.image:
    ref = torch.as_tensor(load_image(args.image), device=device)
  else:
    ref = synthetic_target((args.width, args.height), device=device)

  config = RasterConfig(tile_size=args.tile_size, antialias=args.antialias,
                        compute_point_heuristic=True)

  params, image = fit(ref, n=args.n, target=args.target,
                      total_iters=args.iters, base_lr=args.lr,
                      prune_rate=args.prune_rate,
                      opacity_reg=args.opacity_reg,
                      scale_reg=args.scale_reg, config=config,
                      seed=args.seed, device=device)

  print(f"final: n={params.num_points} psnr={float(psnr(image, ref)):.2f}")
  if args.save:
    np.save(args.save, image.cpu().numpy())


if __name__ == "__main__":
  main()
