#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taichi_gaussian_rasterizer_tpu_torch`)
on one NVIDIA GPU.

Builds the port's CUDA forward raster kernel from the checkout's sources,
holds it against its plain PyTorch version, and drives the serving path,
`render_gaussians`, at the benchmark's size: 1M random gaussians at
2048x1536. Phases, each printing its lines:

1. build -- nvcc builds csrc/raster_forward.cu for sm_90a; prints the
   build time, ptxas's register and spill summary, the card's name and
   power limit.
2. kernel against plain -- about 20k gaussians at 640x480 in float32, in
   all four modes (blending or quantile, conic or antialiased pdf);
   asserts the tolerance below and prints max and p99.99 |diff| and both
   versions' times.
3. the slice at full size -- five renders of RGB features with
   `RasterConfig()` defaults, the count of kernel launches set to 0 just
   before them and read just after; checks one launch per render, finite
   output, weight in [0, 1], a non-zero overlap total, and the rendered
   pixels of 64 seeded tiles against the plain version; prints the median
   ms/frame, the frame split into projection, mapper and raster, and the
   kernel's and the plain version's time over the whole frame.
4. the serving configuration -- the same size with SH degree-3 features,
   `use_sh`, `render_depth` and `render_median_depth` (two kernel launches
   a frame); checks finite output and prints ms/frame.

Tolerance, kernel against plain (float32, same inputs): p99.99 |diff| <=
1e-4 everywhere, and max |diff| <= 2e-2 in blending mode. The two round the
pdf and the transmittance product differently, so a pixel whose alpha lies
within rounding of alpha_threshold can be gated differently: that moves a
blended pixel by at most alpha_threshold times a feature, but in quantile
mode it can select another point outright.

Exits non-zero, with no result line, when there is no CUDA device, when
the port's package is not beside this script, or when any phase fails.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.

    python3 chip_smoke.py [--n N] [--size WIDTH HEIGHT]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

KERNEL_SOURCE = "taichi_gaussian_rasterizer_tpu_torch/csrc/raster_forward.cu"
REPLACES = "taichi_gaussian_rasterizer_tpu/ops/raster/forward.py:75"
TOL_P9999 = 1e-4
TOL_MAX_BLENDING = 2e-2


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      check=True, capture_output=True, text=True, timeout=60).stdout
  return out.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
  """Mean device time of fn over reps calls, by CUDA events."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
  """Median wall time of fn, synchronised before and after each call."""
  times = []
  for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
  return statistics.median(times)


def diff_stats(got: torch.Tensor, want: torch.Tensor):
  """(max, p99.99) of |got - want|."""
  d = (got - want).abs().flatten().sort().values
  return float(d[-1]), float(d[int(0.9999 * (d.numel() - 1))])


def check_close(label: str, got, want, blending: bool):
  mx, p = diff_stats(got, want)
  ok = p <= TOL_P9999 and (not blending or mx <= TOL_MAX_BLENDING)
  print(f"  {label}: max |diff| {mx:.3e}, p99.99 |diff| {p:.3e} "
        f"({'within' if ok else 'OUTSIDE'} tolerance)")
  if not ok:
    raise AssertionError(f"{label}: kernel and plain version disagree")
  return mx


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--n", type=int, default=1_000_000,
                      help="gaussians in the full-size phases")
  parser.add_argument("--size", type=int, nargs=2, default=(2048, 1536),
                      metavar=("WIDTH", "HEIGHT"))
  args = parser.parse_args()

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's kernels run only on an "
          "NVIDIA GPU", file=sys.stderr)
    return 1

  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.ops import lib
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import forward, tiles
  from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import (
      random_3d_gaussians, random_camera)

  torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's einsum
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda")
  kernel = forward.RASTER_FORWARD
  name = torch.cuda.get_device_name(0)
  card = card_line()

  def plain_image(points, features, mapping, size, config, tile_ids=None):
    """The plain version's (tiles, F + 1, P) output, weight in row F."""
    img, w = forward.rasterize_tiles_plain(points, features, mapping, config,
                                           tile_ids=tile_ids)
    return torch.cat([img, w[:, None]], 1)

  def project_and_map(gaussians, camera, config):
    """What render_gaussians does before its rasterize call."""
    points, depths, _ = tgr.project_to_image(gaussians, camera, config)
    near, far = camera.near_plane, camera.far_plane
    ndc = lib.ndc_depth(torch.clamp(depths, min=near), near, far)
    return points, tgr.map_to_tiles(points, ndc[:, 0], camera.image_size,
                                    config)

  # ---- phase 1: build --------------------------------------------------
  print(f"[1 build] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
  kernel.load()
  print(f"[1 build] nvcc built {KERNEL_SOURCE} for sm_90a in "
        f"{kernel.build_seconds:.1f} s")
  for line in kernel.build_log.splitlines():
    if "registers" in line or "spill" in line or "Compiling entry" in line:
      print(f"  ptxas: {line.strip()}")

  with torch.no_grad():
    # ---- phase 2: kernel against plain, all four modes -----------------
    size2, n2 = (640, 480), 20_000
    gen = torch.Generator(device=dev).manual_seed(1)
    camera2 = random_camera(gen, image_size=size2)
    # larger, more opaque splats than the defaults so that most pixels
    # saturate and the saturation gate and early exit decide the result
    scene2 = random_3d_gaussians(gen, n2, camera2, scale_factor=2.0,
                                 alpha_range=(0.5, 0.99))
    config2 = tgr.RasterConfig()
    points2, mapping2 = project_and_map(scene2, camera2, config2)
    features2 = scene2.feature.contiguous()
    print(f"[2 kernel vs plain] {n2} gaussians @{size2[0]}x{size2[1]}, "
          f"{int(mapping2.total_overlaps)} overlaps, float32")
    for antialias in (False, True):
      for blending in (True, False):
        cfg = config2.replace(antialias=antialias,
                              use_alpha_blending=blending)
        image, weight = forward.rasterize_forward(points2, features2,
                                                  mapping2, size2, cfg)
        torch.cuda.synchronize()
        got = torch.cat([image, weight[..., None]], -1)
        want = tiles.tiles_to_image(
            plain_image(points2, features2, mapping2, size2, cfg),
            mapping2.tile_shape, cfg.tile_size, size2)
        label = (f"{'blending' if blending else 'quantile'}/"
                 f"{'antialias' if antialias else 'conic'}")
        check_close(label, got, want, blending)
        if blending and not antialias:
          saturated = float((weight >= cfg.saturate_threshold).float().mean())
          print(f"    saturated pixels {saturated:.3f}")
        k_ms = cuda_ms(lambda: forward.rasterize_forward(
            points2, features2, mapping2, size2, cfg), reps=20)
        p_ms = cuda_ms(lambda: plain_image(points2, features2, mapping2,
                                           size2, cfg), reps=3)
        print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")

    # ---- phase 3: the slice at full size -------------------------------
    width, height = args.size
    gen = torch.Generator(device=dev).manual_seed(0)
    camera = random_camera(gen, image_size=(width, height))
    scene = random_3d_gaussians(gen, args.n, camera)
    config = tgr.RasterConfig()
    print(f"[3 render] {args.n} gaussians @{width}x{height}, RGB, "
          f"RasterConfig() defaults")

    kernel.launch_count = 0
    frame_ms = []
    for _ in range(5):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      r = tgr.render_gaussians(scene, camera, config)
      torch.cuda.synchronize()
      frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernel.launch_count
    print(f"  launches of the kernel in 5 renders: {launches}")
    assert launches == 5, f"expected one kernel launch per render, got {launches}"

    assert r.image.shape == (height, width, 3) and r.image.is_cuda
    assert torch.isfinite(r.image).all() and torch.isfinite(r.image_weight).all()
    w_min, w_max = float(r.image_weight.min()), float(r.image_weight.max())
    assert w_min >= 0.0 and w_max <= 1.0 + 1e-5, (w_min, w_max)
    points, mapping = project_and_map(scene, camera, config)
    total = int(mapping.total_overlaps)
    assert total > 0
    n_tiles = mapping.tile_ranges.shape[0]
    bins = (mapping.tile_ranges[:, 1] - mapping.tile_ranges[:, 0]).float()
    print(f"  {int(r.points_in_view.sum())} in view, {total} overlaps "
          f"({total / args.n:.2f}/point), {n_tiles} tiles, bin mean "
          f"{float(bins.mean()):.1f} max {int(bins.max())}, weight in "
          f"[{w_min:.4f}, {w_max:.4f}], saturated pixels "
          f"{float((r.image_weight >= config.saturate_threshold).float().mean()):.4f}")

    ids = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(64))[:64]
    rendered = tiles.image_to_tiles(
        torch.cat([r.image, r.image_weight[..., None]], -1),
        mapping.tile_shape, config.tile_size)[ids.to(dev)]
    inside = tiles.image_to_tiles(
        torch.ones(height, width, 1, device=dev), mapping.tile_shape,
        config.tile_size)[ids.to(dev)] > 0
    want = plain_image(points, scene.feature, mapping, (width, height), config,
                       tile_ids=ids.tolist())
    max_err = check_close("64 seeded tiles, render vs plain",
                          rendered, want * inside, blending=True)
    print(f"  ms/frame median {statistics.median(frame_ms):.3f} "
          f"(5 renders: {', '.join(f'{t:.3f}' for t in frame_ms)})")

    features = scene.feature
    proj_ms = host_ms(lambda: tgr.project_to_image(scene, camera, config), 5)
    map_ms = host_ms(lambda: project_and_map(scene, camera, config), 5) - proj_ms
    raster_ms = host_ms(lambda: tgr.rasterize_with_tiles(
        points, features, mapping, (width, height), config), 5)
    print(f"  frame split (host clock, synchronised, median of 5): projection "
          f"{proj_ms:.3f} ms, mapper {map_ms:.3f} ms, raster {raster_ms:.3f} ms")
    k_ms = cuda_ms(lambda: forward.rasterize_forward(
        points, features, mapping, (width, height), config), reps=10)
    p_ms = cuda_ms(lambda: plain_image(points, features, mapping,
                                       (width, height), config), reps=1)
    print(f"  raster over the whole frame (CUDA events): kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 4: the serving configuration ----------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    scene_sh = random_3d_gaussians(gen, args.n, camera, sh_degree=3)
    print(f"[4 serve] {args.n} gaussians @{width}x{height}, SH degree 3, "
          f"render_depth, render_median_depth")
    kernel.launch_count = 0
    sh_ms = []
    for _ in range(3):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      r = tgr.render_gaussians(scene_sh, camera, config, use_sh=True,
                               render_depth=True, render_median_depth=True)
      torch.cuda.synchronize()
      sh_ms.append((time.perf_counter() - t0) * 1e3)
    assert kernel.launch_count == 6, kernel.launch_count
    for field in ("image", "image_weight", "depth", "depth_var", "median_depth"):
      value = getattr(r, field)
      assert value.shape[:2] == (height, width), (field, value.shape)
      assert torch.isfinite(value).all(), field
    covered = r.image_weight > 0.5
    print(f"  launches {kernel.launch_count} in 3 renders; median depth "
          f"{float(r.median_depth[covered].median()):.3f}, blended depth "
          f"{float(r.depth[covered].median()):.3f} over {float(covered.float().mean()):.3f} "
          f"of pixels")
    print(f"  ms/frame median {statistics.median(sh_ms):.3f} "
          f"(3 renders: {', '.join(f'{t:.3f}' for t in sh_ms)})")

  print(card_line())
  print(json.dumps({"kernels": [{
      "name": "raster_forward", "route": "cuda", "source": KERNEL_SOURCE,
      "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
      "ms": k_ms, "plain_ms": p_ms}]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
