#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taichi_gaussian_rasterizer_tpu_torch`)
on one NVIDIA GPU.

Builds the port's three CUDA kernels from the checkout's sources, holds
each against its plain PyTorch version, and drives the serving path,
`render_gaussians` (also with per-point visibility and 16-bit depth
keys), the training frame, `render_gaussians` then `loss.backward()`, at
the benchmark's size, 1M random gaussians at 2048x1536, the 2D
image-fitting trainer, `fit`, growing to 1M gaussians on a 2048x1536
target, and the trained-scene path: a 1M-gaussian trained-like scene
loaded from a 3DGS `.ply`, served and trained with saturation-front
truncation, the multi-GPU module `parallel/` on a one-rank NCCL world,
a feature-field frame of 34 blended channels, past the register
kernels' 16, tile sizes of 12 and 40 pixels, and the optimizer step's
kernel at the training cells' 6.1M points. Phases, each printing its
lines:

1. build -- nvcc builds csrc/raster_forward.cu, raster_backward.cu,
   segment_sum.cu, sh.cu and optim.cu for sm_90a, one process each, all
   at once;
   prints the build times, ptxas's register and spill summary, the
   card's name and power limit.
2. forward kernel against plain -- about 20k gaussians at 640x480 in
   float32, in all four modes (blending or quantile, conic or antialiased
   pdf); asserts the tolerance below and prints max and p99.99 |diff| and
   both versions' times.
2b. backward kernels against plain -- phase 2's scene with a seeded
   cotangent image and weight: the backward kernel's slot rows against
   the plain backward on every slot, conic and antialias, with and
   without the heuristic and visibility rows; the segment-sum kernel
   against the plain segment sum; two runs of each bitwise identical; the
   one-pass reduction of the slot-major rows (the sort and segment_sum.cu's
   point sums) bit for bit the gathered segment sums.
   Prints the relative max and p99.99 |diff| and both versions' times.
2c. forward visibility against plain -- phase 2's scene, all four modes:
   the kernel's per-slot visibility against the plain version's, two runs
   bitwise identical, and in blending mode the per-point sums (kernel 3)
   adding up to the weight image to relative 1e-5; both versions' times.
2d. the forward's per-tile saturation front against plain -- phase 2's
   scene, blending, conic and antialias, with and without visibility:
   `tile_front` from the kernel against the plain version's; the tiles
   whose fronts differ are at most 0.5% of the non-empty tiles and each
   one of them a tile where the two images differ (a gate flipped between
   the two roundings); two runs bitwise identical; the kernel's time with
   and without the front, and the plain version's.
3. the serving slice at full size -- five renders of RGB features with
   `RasterConfig()` defaults, the launch counts set to 0 just before them
   and read just after; checks one forward launch per render, finite
   output, weight in [0, 1], a non-zero overlap total, and the rendered
   pixels of 64 seeded tiles against the plain version; prints the median
   ms/frame, the frame split into projection, mapper and raster, and the
   kernel's and the plain version's time over the whole frame.
4. the serving configuration -- the same size with SH degree-3 features,
   `use_sh`, `render_depth` and `render_median_depth` (two raster launches
   and one SH launch a frame); checks finite output and prints ms/frame.
   The SH kernels (csrc/sh.cu) against the plain version on the scene:
   colours within 1e-5 and d_sh (seeded cotangent) within 1e-6 of
   autograd's through the plain version, rows within 1e-5 of the clamp's
   ends left out; prints each kernel's ms beside its bound in bytes, the
   plain version's forward and backward, and the einsum and its backward
   (the library calls the plain version makes).
4b. serving with visibility and depth16 -- phase 3's scene, three renders
   with `RasterConfig(compute_visibility=True)`: one forward and one
   segment-sum launch a render, visibility >= 0 adding up to the weight
   image; then three with `use_depth16=True` as well: the same overlap
   total as the full-depth mapping, and the image's max and p99.99 |diff|
   against the full-depth render; ms/frame of each.
5. the training frame at full size -- five steps of render_gaussians,
   loss sum(image * G) with G a seeded normal image, loss.backward() and
   a plain SGD update; checks one launch of each kernel per step and
   finite, non-zero gradients on all five Gaussians3D tensors; holds the
   backward kernel's slot rows on 64 seeded tiles against the plain
   version, the segment-sum kernel over the whole frame, and the one-pass
   reduction bit for bit the gathered segment sums; prints the
   median ms/step, its split, the kernels' and plain versions' times and
   peak device memory.
6. training mode -- three `render_with_heuristics` steps at the same
   size; checks finite heuristics and visibility >= 0; prints ms/step.
7. the 2D trainer at full size -- `fit(synthetic_target((2048, 1536)),
   n=500_000, target=1_000_000, total_iters=60,
   config=RasterConfig(compute_point_heuristic=True), seed=0)`: epochs of
   11, 16 and 33 steps with two split/prune rounds. Checks one launch of
   each kernel a step, 1,000,000 points at the end with every optimizer
   state row count equal to it, finite parameters and the last epoch's
   PSNR above the first's; prints each epoch's N, PSNR, loss, median
   ms/step and split and prune counts, and the peak device memory.
8. the trained-scene path at full size -- `trained_like_gaussians` (seed
   4) at phase 3's size, written with `save_gaussians_ply`, read back
   with `load_gaussians_ply(morton_order=True)` onto the card, its DC band
   as RGB; `probe_visit_chunks(margin_chunks=0)`. Prints the PLY times,
   overlaps/point, points per tile p10/p50/p90/p99/max, the footprint clip
   flag, visit_capacity / K and the kept slots. Serving: three renders
   with the probed `visit_chunks` and three without, one forward launch
   each; `raster_overflow` False and image and weight equal bit for bit;
   ms/frame and the split into probe, projection, mapper, truncate and
   raster. The backward kernel and the reduction on both mappings.
   Training: five steps (project_to_image, map_to_tiles,
   rasterize_with_tiles, loss sum(image * G), backward, SGD) through
   `TruncationGuard(config, margin_chunks=0)` and five untruncated: one
   launch of each kernel a step plus the guard's probes and re-renders,
   finite non-zero gradients on all five tensors, equal bit for bit to the
   untruncated step's at every step; ms/step and peak device memory; the
   same steps through guards with margin_chunks 1, 4 and 16, their reprobes
   and ms/step, held to the same gradients; at each reprobe, how many
   tiles the previous probe crops on the new frame and how many of those
   it had kept whole; and, one SGD step on, how many truncated tiles the
   first frame's probe crops and why. Then
   `bench.py`'s ms_heavy scene (`random_3d_gaussians`, scale_factor 4,
   alpha 0.75-0.99) at the same size: one render and three steps each
   way, held to the same equalities.
9. the parallel path at full size -- a world of one rank, NCCL on this
   card, from `make_mesh()` (`env://` set as torchrun sets it), on phase
   3's scene: (a) three `dp_train_step` steps with two cameras a rank
   (phase 3's and one moved 0.02 along x), seeded targets,
   `RasterConfig(compute_visibility=True)` and `VisibilityAwareAdam`;
   the first step equal bit for bit (loss, parameters, moments, running
   visibility, total weight) to the same step written out without the
   group; 2 forward, 2 backward and 4 segment-sum launches a step; ms/step.
   (b) `pp_project` equal bit for bit to `project_to_image`. (c)
   `tp_rasterize`'s stripe body (`tp_rasterize_stripe`) looped over 4
   equal stripes (384 rows each) and over
   `balance_stripe_rows(stripe_row_loads(...), 4)`, the footprint clip
   flag asserted clear: the assembled image and weight within rtol 1e-4 /
   atol 2e-5 of the full-frame render (the stripe shift re-rounds a
   mean's offset inside its tile), with the max |diff|, the share of
   bit-equal pixels, each stripe's rows, overlap load and ms. (d)
   `tp_train_step`'s stripe body (`tp_train_stripe`) looped over the same
   stripes with local_points = N and
   `RasterConfig(compute_point_heuristic=True)`: zero dropped, the summed
   loss within relative 1e-5 and the gradients, heuristics and visibility
   within 1e-3 of their largest |value| of the full-frame training step.
   The group is destroyed at the end of the phase.
10. the feature field at full size -- phase 3's scene with seeded raw
   (N, 32) features, `render_gaussians(use_sh=False, render_depth=True)`:
   34 blended channels, which take the kernels' channel-group instances.
   The launch counts set to 0 before five serving renders and five
   training steps (loss sum(image * G) + sum(depth * G_d), G seeded
   normal, loss.backward(), SGD) and read after them: one forward launch a
   render, one launch of each kernel a step; finite, non-zero gradients on
   all five Gaussians3D tensors at every step; the render's image equal
   to the kernel's channels 2: on the same inputs. The forward and the
   backward rows (a seeded normal cotangent on all 34 channels) on 64
   seeded tiles against the plain versions, the backward bitwise the same
   on a second run, the point sums of its 40 slot-major rows over the
   whole frame against plain; the reduction of 137 seeded slot-major rows
   (a Feature 3DGS backward's 6 + 3 + 128) over the frame's slots: one
   point-sum launch, bit for bit the gathered segment sums, and within the
   segment-sum tolerance of the plain segment sum; ms/frame, ms/step, peak device memory, and each
   kernel's, plain version's and (point sums) `index_add_`'s time beside
   its bound. Then at F = 17, 64 and 128 (seeded raw features, no depth):
   a serving render and a training step through `render_gaussians`,
   finite, the forward and backward on 64 seeded tiles against plain,
   and both kernels' times beside their bounds. The JSON line's launches,
   errors, times and bounds are this phase's 34-channel frame's.
11. tile sizes at full size -- phase 3's scene, RGB and the feature field
   (32 seeded raw channels + render_depth, 34 blended), with
   `RasterConfig(tile_size=12)` (tiles that are not whole warps: blocks
   padded with idle lanes) and `tile_size=40` (tiles larger than a block:
   pixel chunks): a serving render and a training step through
   `render_gaussians`, the counts set to 0 before them and read after
   (one launch of each kernel a step, two forwards in all); finite
   output, finite non-zero gradients on all five tensors; the forward and
   the backward rows on 64 seeded tiles against the plain versions; each
   kernel's time beside its bound.
12. the optimizer step's kernel (csrc/optim.cu) -- `ParameterClass.step`
   through the kernel against the same steps through the plain passes of
   optim/kernels.py on the card, every instance (Adam and LaProp; scalar,
   vector and local_vector groups; visibility-aware, point_lr and mask_lr
   each on and off; float32 and float64), three steps of fractional
   weights with zeros at 20,011 points: one launch a group a step, scalar
   groups bit for bit, vector groups within 1e-5 of the largest plain
   value (the squared norm added in another order than torch.sum's), rows
   never stepped unchanged. Then one scalar group at 6.1M points of each
   width the training cells have (1, 3, 4, 48, 128): bit for bit, one
   launch, weight-0 rows unchanged, the kernel's and the plain passes'
   ms beside the bound (28 bytes an element and 8 a point); and the
   whole steps of bicycle6m (6.1M x 59, five groups) and Feature 3DGS
   (6.1M x 187, six), FractionalAdam at unit weights, from moments one
   step old: the launch count set to 0 just before one step and read
   just after (one a group), the same step from a copy of the state
   through the plain passes, bit for bit (param, m, v and the total
   weight), then the ms against the bound (28 bytes an element, 12 a
   point), the plain step's ms and each one's device memory above the
   state. The JSON line's optim_step entry is the bicycle6m step's:
   its launches, its measured largest |kernel - plain| and its times.
   The instances' cases, inputs and comparison are the ones
   tests/test_torch_optim_kernel.py runs (`OPTIM_CASES`,
   `optim_kernel_against_plain`).

Truncation is exact, so phase 8 holds the truncated frame to the
untruncated one bit for bit: it keeps each tile's bin up to where every
pixel has stopped, in the same order, so each pixel blends the same
slots; the dropped slots' gradient rows are exact zeros, and kernel 3
adds each point's slots in slot order, so their zeros drop out exactly.

Tolerances (float32, kernel against plain on the same inputs):
* forward: p99.99 |diff| <= 1e-4 everywhere, and max |diff| <= 2e-2 in
  blending mode. The two round the pdf and the transmittance product
  differently, so a pixel whose alpha lies within rounding of
  alpha_threshold can be gated differently: that moves a blended pixel by
  at most alpha_threshold times a feature, but in quantile mode it can
  select another point outright.
* backward slot rows: per row, p99.99 |diff| <= 1e-4 and max |diff| <=
  1e-2 relative to the row's largest |plain| value: the two add a slot's
  pixels and the running sum C in different orders, and E - C cancels
  where a pixel has little weight left.
* segment sums: max |diff| <= 1e-5 of the row's largest |plain| value
  (sums of a few slots, in another order).
* forward visibility: the forward's tolerances above, on the per-slot
  sums.

Phases 2b, 2c, 3, 4b, 5, 8, 10 and 11 print each kernel's bound beside its time: the
larger of its bytes over the card's memory rate and its FP32 operations
over the card's FP32 rate, the operations counted on the (pixel, slot)
pairs of the phase's own frame whose alpha passes the threshold
(`ops/raster/bounds.py`), and the share of it the kernel reaches.

Exits non-zero, with no result line, when there is no CUDA device, when
the port's package is not beside this script, or when any phase fails.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.

    python3 chip_smoke.py [--n N] [--size WIDTH HEIGHT]
"""

import argparse
import dataclasses
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

CSRC = "taichi_gaussian_rasterizer_tpu_torch/csrc/"
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "raster_forward": (CSRC + "raster_forward.cu",
                       "taichi_gaussian_rasterizer_tpu/ops/raster/forward.py:75"),
    "raster_backward": (CSRC + "raster_backward.cu",
                        "taichi_gaussian_rasterizer_tpu/ops/raster/backward.py:83"),
    "segment_sum": (CSRC + "segment_sum.cu",
                    "taichi_gaussian_rasterizer_tpu/ops/raster/reduce.py:37"),
    "optim_step": (CSRC + "optim.cu",
                   "none: taichi_gaussian_rasterizer_tpu/optim/kernels.py is plain jnp"),
}
TOL_P9999 = 1e-4
TOL_MAX_BLENDING = 2e-2
TOL_ROWS_MAX = 1e-2
TOL_SEGMENT = 1e-5
TOL_SH_COLOR = 1e-5   # tests/test_torch_sh.py's float32 tolerances
TOL_SH_D_SH = 1e-6
TOL_OPTIM_VECTOR = 1e-5   # the squared norm in row order (optim_kernel_against_plain)
HBM_BYTES_PER_S = 3.35e12


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


def check_rows(label: str, got, want):
  """Slot rows (R, K): per row, (max, p99.99) of |diff| relative to the
  row's largest |want|; asserts the backward tolerance. Returns the
  largest absolute |diff|."""
  scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
  rel = ((got - want).abs() / scale).sort(dim=1).values
  mx = float(rel[:, -1].max())
  p = float(rel[:, int(0.9999 * (rel.shape[1] - 1))].max())
  ok = p <= TOL_P9999 and mx <= TOL_ROWS_MAX
  print(f"  {label}: {got.shape[0]} rows x {got.shape[1]} slots, relative max "
        f"|diff| {mx:.3e}, p99.99 {p:.3e} ({'within' if ok else 'OUTSIDE'} "
        f"tolerance)")
  if not ok:
    raise AssertionError(f"{label}: backward kernel and plain version disagree")
  return float((got - want).abs().max())


def check_segment_sums(label: str, got, want):
  scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
  rel = float(((got - want).abs() / scale).max())
  ok = rel <= TOL_SEGMENT
  print(f"  {label}: relative max |diff| {rel:.3e} "
        f"({'within' if ok else 'OUTSIDE'} tolerance)")
  if not ok:
    raise AssertionError(f"{label}: segment-sum kernel and plain disagree")
  return float((got - want).abs().max())


def bound_line(b, ms):
  """A kernel's bound on a frame beside its measured time."""
  return (f"bound {b['ms']:.4f} ms ({b['bound_by']}: {b['ops'] / 1e9:.3f} "
          f"GFLOP, {b['bytes'] / 1e6:.1f} MB), share {b['ms'] / ms:.3f}")


def sh_bytes(n: int, c: int, k: int, itemsize: int = 4) -> dict:
  """Bytes the SH kernels must move at least: the forward reads the
  coefficients and positions and writes the colours (and, for a gradient,
  the clamp's byte gate); the backward reads the cotangent, the gate and
  the positions and writes d_sh."""
  forward = (n * c * k + 3 * n + n * c) * itemsize
  return dict(forward=forward, forward_gate=forward + n * c,
              backward=(n * c + 3 * n + n * c * k) * itemsize + n * c)


def sh_kernels(sh_ops, feats, pos, cam, reps: int = 20) -> dict:
  """The SH kernels against the plain version on (N, C, K) coefficients,
  a seeded cotangent, and the times of the kernels, the plain version and
  its einsum (CUDA events). Returns the numbers printed."""
  n, c, k = feats.shape
  gen = torch.Generator(device=feats.device).manual_seed(4)
  grad = torch.rand((n, c), generator=gen, device=feats.device) * 2 - 1
  launches = (sh_ops.SH_FORWARD.launch_count, sh_ops.SH_BACKWARD.launch_count)
  with torch.enable_grad():
    leaf = feats.detach().clone().requires_grad_()
    color = sh_ops.evaluate_sh_at(leaf, pos, cam)
    (color * grad).sum().backward()
    plain_leaf = feats.detach().clone().requires_grad_()
    want = sh_ops.evaluate_sh_plain(plain_leaf, pos, cam)
    (want * grad).sum().backward()
  torch.cuda.synchronize()
  assert (sh_ops.SH_FORWARD.launch_count, sh_ops.SH_BACKWARD.launch_count) == (
      launches[0] + 1, launches[1] + 1)
  d = sh_ops.lib.safe_normalize(pos.double() - cam.double())
  x = torch.einsum("nck,nk->nc", feats.double(),
                   sh_ops.rsh_cart(d, sh_ops.check_sh_degree(feats))) + 0.5
  sure = (x.abs() > TOL_SH_COLOR) & ((x - 1).abs() > TOL_SH_COLOR)
  color_err = float((color - want).detach().abs().max())
  d_sh_err = float((leaf.grad - plain_leaf.grad)[sure].abs().max())
  out = dict(color_err=color_err, d_sh_err=d_sh_err,
             near_clamp_rows=int((~sure).sum()))
  ok = color_err <= TOL_SH_COLOR and d_sh_err <= TOL_SH_D_SH
  print(f"  SH kernels against plain, {n} x {c} x {k}: colour max |diff| "
        f"{color_err:.3e}, d_sh max |diff| {d_sh_err:.3e} over all but "
        f"{out['near_clamp_rows']} rows within {TOL_SH_COLOR} of the clamp's "
        f"ends ({'within' if ok else 'OUTSIDE'} tolerance)")
  if not ok:
    raise AssertionError("SH kernels and plain version disagree")
  del leaf, plain_leaf, color, want, x, d, sure

  feats, pos = feats.detach(), pos.detach()
  _, gate = sh_ops._launch_forward(feats, pos, cam, True)
  basis = sh_ops.rsh_cart(sh_ops.lib.safe_normalize(pos - cam),
                          sh_ops.check_sh_degree(feats))
  with torch.enable_grad():
    leaf = feats.clone().requires_grad_()
    plain_out = sh_ops.evaluate_sh_plain(leaf, pos, cam)
    einsum_out = torch.einsum("nck,nk->nc", leaf, basis)
  ms = dict(
      forward=cuda_ms(lambda: sh_ops._launch_forward(feats, pos, cam, False), reps),
      forward_gate=cuda_ms(lambda: sh_ops._launch_forward(feats, pos, cam, True),
                           reps),
      backward=cuda_ms(lambda: sh_ops._launch_backward(grad, gate, pos, cam, None,
                                                       k, True), reps),
      plain_forward=cuda_ms(lambda: sh_ops.evaluate_sh_plain(feats, pos, cam), 5),
      plain_backward=cuda_ms(lambda: torch.autograd.grad(
          plain_out, leaf, grad, retain_graph=True), 5),
      einsum=cuda_ms(lambda: torch.einsum("nck,nk->nc", feats, basis), 5),
      einsum_backward=cuda_ms(lambda: torch.autograd.grad(
          einsum_out, leaf, grad, retain_graph=True), 5))
  nbytes = sh_bytes(n, c, k, feats.element_size())
  for name in ("forward", "forward_gate", "backward"):
    bound = nbytes[name] / HBM_BYTES_PER_S * 1e3
    print(f"  SH {name.replace('_', ' + ')} kernel {ms[name]:.4f} ms; bound "
          f"{bound:.4f} ms (bytes: {nbytes[name] / 1e6:.1f} MB), share "
          f"{bound / ms[name]:.3f}")
  print(f"  SH plain forward {ms['plain_forward']:.4f} ms, backward "
        f"{ms['plain_backward']:.4f} ms; its einsum {ms['einsum']:.4f} ms, "
        f"the einsum's backward {ms['einsum_backward']:.4f} ms")
  out.update(ms=ms, bytes=nbytes)
  return out


def ptxas_summary(log: str) -> str:
  regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
  spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
  if not regs:
    return "no ptxas output (already built)"
  return (f"{len(regs)} entries, {min(regs)}-{max(regs)} registers, "
          f"spill stores {min(spills)}-{max(spills)} bytes")


def project_and_map(gaussians, camera, config, use_depth16=False):
  """What render_gaussians does before its rasterize call: (points,
  mapping)."""
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.ops import lib
  points, depths, _ = tgr.project_to_image(gaussians, camera, config)
  near, far = camera.near_plane, camera.far_plane
  ndc = lib.ndc_depth(torch.clamp(depths, min=near), near, far)
  return points, tgr.map_to_tiles(points, ndc[:, 0], camera.image_size,
                                  config, use_depth16=use_depth16)


def bench_scene(n: int, size, device):
  """bench.py's recipe at n gaussians (random_camera, then
  random_3d_gaussians, from seed 0): (scene, camera)."""
  from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import (
      random_3d_gaussians, random_camera)
  gen = torch.Generator(device=device).manual_seed(0)
  camera = random_camera(gen, image_size=tuple(size))
  return random_3d_gaussians(gen, n, camera), camera


def saturating_frame(device):
  """Phase 2's frame: 20k gaussians at 640x480 (seed 1), larger and more
  opaque than the defaults (scale x2, alpha 0.5-0.99) so that most pixels
  saturate and the saturation gate and early exit decide the result;
  RasterConfig(), the projected points, their mapping, the features and a
  seeded cotangent image and weight (seed 3)."""
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import (
      random_3d_gaussians, random_camera)
  size, n = (640, 480), 20_000
  gen = torch.Generator(device=device).manual_seed(1)
  camera = random_camera(gen, image_size=size)
  scene = random_3d_gaussians(gen, n, camera, scale_factor=2.0,
                              alpha_range=(0.5, 0.99))
  config = tgr.RasterConfig()
  points, mapping = project_and_map(scene, camera, config)
  gen_g = torch.Generator(device=device).manual_seed(3)
  g_image = torch.randn((size[1], size[0], 3), generator=gen_g, device=device)
  g_weight = torch.randn((size[1], size[0]), generator=gen_g, device=device)
  return types.SimpleNamespace(
      size=size, n=n, config=config, points=points, mapping=mapping,
      features=scene.feature.contiguous(), g_image=g_image, g_weight=g_weight)


def train_steps(scene, camera, config, g_image, steps, guard=None, lr=1e-6):
  """`steps` SGD steps on sum(image * G) from `scene`, through the
  package's entry points: project_to_image, map_to_tiles and
  rasterize_with_tiles, with saturation-front truncation through `guard`
  (a TruncationGuard) when one is given, then loss.backward(). Returns
  (each step's gradients, each step's ms on the host clock)."""
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.ops import lib
  params = {f.name: getattr(scene, f.name).detach().clone().requires_grad_()
            for f in dataclasses.fields(tgr.Gaussians3D)}
  size, near, far = camera.image_size, camera.near_plane, camera.far_plane
  grads, times = [], []
  for _ in range(steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gaussians = tgr.Gaussians3D(**params)
    points, depths, _ = tgr.project_to_image(gaussians, camera, config)
    ndc = lib.ndc_depth(torch.clamp(depths, min=near), near, far)
    mapping = tgr.map_to_tiles(points.detach(), ndc[:, 0].detach(), size, config)

    def frame(visit_chunks=None, visit_capacity=None):
      out = tgr.rasterize_with_tiles(points, gaussians.feature, mapping, size,
                                     config, visit_chunks=visit_chunks,
                                     visit_capacity=visit_capacity)
      return out, out.bin_overflow

    out = frame()[0] if guard is None else guard.render(points.detach(),
                                                        mapping, frame)
    (out.image * g_image).sum().backward()
    with torch.no_grad():
      for p in params.values():
        p -= lr * p.grad
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    grads.append({name: p.grad for name, p in params.items()})
    for p in params.values():
      p.grad = None
  return grads, times


def check_grads(label, grads, want=None):
  """Finite, non-zero gradients on every Gaussians3D tensor, and with
  `want` equal to those bit for bit (torch.equal)."""
  for name, g in grads.items():
    assert torch.isfinite(g).all(), f"{label}: non-finite gradient of {name}"
    assert g.abs().sum() > 0, f"{label}: zero gradient of {name}"
    if want is not None:
      assert torch.equal(g, want[name]), (
          f"{label}: {name} gradient differs from the untruncated step's, max "
          f"|diff| {float((g - want[name]).abs().max()):.3e}")


def diagnosed_guard(config, size, margin_chunks):
  """A TruncationGuard that prints, at each reprobe, how many tiles the
  previous probe's fronts crop on the new frame, and how many of those
  that probe had kept whole (its visit reached the bin's end, so its
  margin added nothing there). The diagnosis costs one forward launch a
  reprobe."""
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import forward

  class Guard(tgr.TruncationGuard):
    def probe(self, gaussians2d, mapping):
      g = self.config.points_per_chunk
      if self.visit_chunks is not None:
        tr, cut, drift = tgr.truncate_mapping(mapping, self.visit_chunks,
                                              self.visit_capacity, g)
        *_, front = forward.rasterize_forward(
            gaussians2d, gaussians2d.new_zeros(gaussians2d.shape[0], 1), tr,
            size, self.config, tile_front=True)
        cropped = cut & (front <= 0)
        print(f"    reprobe {self.reprobes}: the previous probe crops "
              f"{int(cropped.sum())} tiles of the new frame (capacity "
              f"overflow {bool(drift)}); that probe had kept "
              f"{int((cropped & self.kept_whole).sum())} of them whole, and "
              f"{int(self.kept_whole.sum())} tiles whole in all")
      super().probe(gaussians2d, mapping)
      starts = mapping.tile_ranges[:, 0].to(torch.int64)
      ends = mapping.tile_ranges[:, 1].to(torch.int64)
      cover = torch.where(ends > starts, -(-ends // g) - starts // g, 0)
      self.kept_whole = self.visit_chunks.to(torch.int64) >= cover

  return Guard(config, margin_chunks=margin_chunks)


def trained_scene(args, dev, card, kernels, camera, g_image):
  """Phase 8: the trained-scene path at full size (module docstring)."""
  import os
  import tempfile
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.io import (load_gaussians_ply,
                                                       save_gaussians_ply)
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
      backward, bounds, forward, reduce_slots_by_point)
  from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import (
      random_3d_gaussians, random_camera, trained_like_gaussians)

  def reset_counts():
    for k in kernels.values():
      k.launch_count = 0

  def counts():
    return {name: k.launch_count for name, k in kernels.items()}

  width, height = args.size
  size = (width, height)
  config = tgr.RasterConfig()
  g = config.points_per_chunk
  print(f"[8 trained scene] trained_like_gaussians({args.n}) @{width}x{height}, "
        f"through a 3DGS .ply, RGB, RasterConfig(); {card}")
  gen = torch.Generator(device=dev).manual_seed(4)
  camera8 = random_camera(gen, image_size=size)
  made = trained_like_gaussians(gen, args.n, camera8)
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "trained_like.ply")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_gaussians_ply(path, made)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_gaussians_ply(path, morton_order=True, device="cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    mbytes = os.path.getsize(path) / 1e6
  # a degree-0 checkpoint: its DC band as plain RGB
  scene = dataclasses.replace(loaded, feature=loaded.feature[:, :, 0].contiguous())
  del made, loaded
  features = scene.feature

  with torch.no_grad():
    points, mapping = project_and_map(scene, camera8, config)
    total, k_slots = int(mapping.total_overlaps), mapping.overlap_to_point.shape[0]
    bins = (mapping.tile_ranges[:, 1] - mapping.tile_ranges[:, 0]).double()
    pct = torch.quantile(bins, torch.tensor([0.1, 0.5, 0.9, 0.99],
                                            dtype=torch.float64, device=dev))
    reset_counts()
    visit, cap = tgr.probe_visit_chunks(points, mapping, config, margin_chunks=0)
    assert counts()["raster_forward"] == 1, counts()
    truncated, _, _ = tgr.truncate_mapping(mapping, visit, cap, g)
    kept = int(truncated.total_overlaps)
    print(f"  .ply {mbytes:.1f} MB written in {write_s:.3f} s, read with Morton "
          f"order onto the card in {read_s:.3f} s; {total} overlaps "
          f"({total / args.n:.2f}/point) in {k_slots} slots; points per tile "
          f"p10/p50/p90/p99 {[int(x) for x in pct.tolist()]} max "
          f"{int(bins.max())}; footprint clip flag {bool(mapping.overflow)}")
    print(f"  probe_visit_chunks(margin_chunks=0): visit_capacity {cap} = "
          f"{cap / k_slots:.4f} of K; the truncated mapping keeps {kept} of "
          f"{k_slots} slots ({kept / k_slots:.4f})")

    # serving: three renders untruncated, three truncated
    renders = {}
    for label, kw in (("untruncated", {}),
                      ("truncated", dict(visit_chunks=visit, visit_capacity=cap))):
      reset_counts()
      times = []
      for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = tgr.render_gaussians(scene, camera8, config, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
      assert counts() == {"raster_forward": 3, "raster_backward": 0,
                          "segment_sum": 0}, counts()
      assert torch.isfinite(r.image).all() and r.image.shape == (height, width, 3)
      renders[label] = r
      print(f"  serving, {label}: ms/frame median {statistics.median(times):.3f} "
            f"(3 renders: {', '.join(f'{t:.3f}' for t in times)}); launches "
            f"{counts()}")
    full, tr = renders["untruncated"], renders["truncated"]
    assert full.raster_overflow is None
    assert not bool(tr.raster_overflow), "truncation cropped a tile"
    assert torch.equal(tr.image, full.image), "truncated image differs"
    assert torch.equal(tr.image_weight, full.image_weight), "truncated weight differs"
    saturated = float((full.image_weight >= config.saturate_threshold).double().mean())
    print(f"  raster_overflow False; image and weight equal to the untruncated "
          f"render's bit for bit; saturated pixels {saturated:.4f}")

    probe_ms = host_ms(lambda: tgr.probe_visit_chunks(points, mapping, config,
                                                      margin_chunks=0), 3)
    proj_ms = host_ms(lambda: tgr.project_to_image(scene, camera8, config), 3)
    map_ms = host_ms(lambda: project_and_map(scene, camera8, config), 3) - proj_ms
    trunc_ms = host_ms(lambda: tgr.truncate_mapping(mapping, visit, cap, g), 3)
    raster_ms = host_ms(lambda: tgr.rasterize_with_tiles(
        points, features, mapping, size, config), 3)
    raster_tr_ms = host_ms(lambda: tgr.rasterize_with_tiles(
        points, features, mapping, size, config, visit_chunks=visit,
        visit_capacity=cap), 3)
    fwd_full_ms = cuda_ms(lambda: forward.rasterize_forward(
        points, features, mapping, size, config), reps=10)
    fwd_tr_ms = cuda_ms(lambda: forward.rasterize_forward(
        points, features, truncated, size, config, tile_front=True), reps=10)
    print(f"  frame split (host clock, synchronised, median of 3): probe "
          f"{probe_ms:.3f} ms, projection {proj_ms:.3f} ms, mapper {map_ms:.3f} "
          f"ms, truncate {trunc_ms:.3f} ms, raster {raster_ms:.3f} ms "
          f"untruncated / {raster_tr_ms:.3f} ms truncated (truncate included); "
          f"forward kernel (CUDA events) {fwd_full_ms:.4f} ms on the {k_slots} "
          f"slots, {fwd_tr_ms:.4f} ms on the {kept} kept slots with tile_front")
    # the work the function needs lies in the kept prefixes; the bytes
    # bound counts each mapping's own slots
    work = bounds.raster_work(points, truncated, config, size)
    n_tiles = mapping.tile_ranges.shape[0]
    fwd_bounds = [bounds.forward_bound(work, args.n, 3, k, n_tiles, size, False)
                  for k in (k_slots, kept)]
    print(f"  {work['evaluated']} (pixel, slot) pairs before the pixels stop, "
          f"{work['active']} above the alpha threshold; forward kernel "
          f"untruncated: {bound_line(fwd_bounds[0], fwd_full_ms)}; truncated: "
          f"{bound_line(fwd_bounds[1], fwd_tr_ms)}")

    # the backward kernel and the reduction on both mappings
    image, weight = forward.rasterize_forward(points, features, mapping, size,
                                              config)
    zeros = torch.zeros_like(weight)
    bw = {name: (points, features, m, config, image, weight, g_image, zeros)
          for name, m in (("untruncated", mapping), ("truncated", truncated))}
    slots = {name: backward.rasterize_backward(*a) for name, a in bw.items()}
    for name, a in bw.items():
      m = a[2]
      b_ms = cuda_ms(lambda: backward.rasterize_backward(*a), reps=5)
      r_ms = cuda_ms(lambda: reduce_slots_by_point(slots[name], m), reps=5)
      b = bounds.backward_bound(work, args.n, 3, m.overlap_to_point.shape[0],
                                n_tiles, size, False, False, False)
      print(f"  {name} mapping, {m.overlap_to_point.shape[0]} slots: backward "
            f"kernel {b_ms:.4f} ms, {bound_line(b, b_ms)}; reduction (sort + "
            f"point sums) {r_ms:.4f} ms (CUDA events)")
    del image, weight, slots, bw

  # training: five steps through TruncationGuard and five untruncated
  steps = 5
  torch.cuda.reset_peak_memory_stats()
  guard = diagnosed_guard(config, size, 0)
  reset_counts()
  grads_tr, times_tr = train_steps(scene, camera8, config, g_image, steps, guard)
  launches = counts()
  peak_tr = torch.cuda.max_memory_allocated() / 2**30
  torch.cuda.reset_peak_memory_stats()
  reset_counts()
  grads_full, times_full = train_steps(scene, camera8, config, g_image, steps)
  launches_full = counts()
  peak_full = torch.cuda.max_memory_allocated() / 2**30
  print(f"  training, {steps} steps through TruncationGuard(config, "
        f"margin_chunks=0): {guard.reprobes} reprobes, launches {launches}; "
        f"untruncated: launches {launches_full}")
  # a probe, a re-render and the diagnosis's forward a reprobe
  assert launches == {"raster_forward": steps + 1 + 3 * guard.reprobes,
                      "raster_backward": steps, "segment_sum": steps}, launches
  assert all(v == steps for v in launches_full.values()), launches_full
  for i, (got, want) in enumerate(zip(grads_tr, grads_full)):
    check_grads(f"step {i}", got, want)
  print(f"  finite, non-zero gradients on all five tensors, equal bit for bit "
        f"to the untruncated steps' at every step")
  print(f"  ms/step median {statistics.median(times_tr):.3f} truncated "
        f"({', '.join(f'{t:.3f}' for t in times_tr)}; the first includes the "
        f"probe), {statistics.median(times_full):.3f} untruncated "
        f"({', '.join(f'{t:.3f}' for t in times_full)}); peak device memory "
        f"{peak_tr:.2f} / {peak_full:.2f} GiB")
  # the SGD steps move the fronts and shift every later tile's start
  # against the chunk grid: how much margin keeps the guard from reprobing
  for margin in (1, 4, 16):
    guard_m = diagnosed_guard(config, size, margin)
    reset_counts()
    grads_m, times_m = train_steps(scene, camera8, config, g_image, steps, guard_m)
    for i, (got, want) in enumerate(zip(grads_m, grads_full)):
      check_grads(f"margin {margin}, step {i}", got, want)
    print(f"  through TruncationGuard(config, margin_chunks={margin}): "
          f"{guard_m.reprobes} reprobes, launches {counts()}, capacity "
          f"{guard_m.visit_capacity}; gradients equal bit for bit too; ms/step "
          f"median {statistics.median(times_m):.3f} "
          f"({', '.join(f'{t:.3f}' for t in times_m)})")
  # why the guard reprobes: one SGD step later, which truncated tiles the
  # first frame's probe crops, and whether they still saturate at all
  with torch.no_grad():
    moved = tgr.Gaussians3D(**{k: getattr(scene, k) - 1e-6 * grads_full[0][k]
                               for k in grads_full[0]})
    points1, mapping1 = project_and_map(moved, camera8, config)
    *_, front_full = forward.rasterize_forward(points1, moved.feature, mapping1,
                                               size, config, tile_front=True)
    for margin in (0, 16):
      visit_m, _ = tgr.probe_visit_chunks(points, mapping, config, margin)
      tr1, cut, _ = tgr.truncate_mapping(mapping1, visit_m, None, g)
      *_, front_tr = forward.rasterize_forward(points1, moved.feature, tr1, size,
                                               config, tile_front=True)
      cropped = cut & (front_tr <= 0)
      print(f"  one SGD step on, the first frame's margin-{margin} probe crops "
            f"{int(cropped.sum())} of its {int(cut.sum())} truncated tiles: "
            f"{int((cropped & (front_full < 0)).sum())} of them no longer "
            f"saturate within their whole bin, "
            f"{int((cropped & (front_full > 0)).sum())} saturate past the kept "
            f"prefix")
  del grads_tr, grads_full, grads_m

  # ms_heavy's scene: one truncated and one untruncated step
  gen = torch.Generator(device=dev).manual_seed(5)
  heavy = random_3d_gaussians(gen, args.n, camera, scale_factor=4.0,
                              alpha_range=(0.75, 0.99))
  with torch.no_grad():
    points_h, mapping_h = project_and_map(heavy, camera, config)
    visit_h, cap_h = tgr.probe_visit_chunks(points_h, mapping_h, config,
                                            margin_chunks=0)
    kept_h = int(tgr.truncate_mapping(mapping_h, visit_h, cap_h, g)[0].total_overlaps)
    full_h = tgr.render_gaussians(heavy, camera, config)
    tr_h = tgr.render_gaussians(heavy, camera, config, visit_chunks=visit_h,
                                visit_capacity=cap_h)
    assert not bool(tr_h.raster_overflow), "heavy: truncation cropped a tile"
    assert torch.equal(tr_h.image, full_h.image), "heavy: truncated image differs"
    assert torch.equal(tr_h.image_weight, full_h.image_weight)
  k_h = mapping_h.overlap_to_point.shape[0]
  guard_h = diagnosed_guard(config, size, 0)
  g_tr, t_tr = train_steps(heavy, camera, config, g_image, 3, guard_h)
  g_full, t_full = train_steps(heavy, camera, config, g_image, 3)
  for i, (got, want) in enumerate(zip(g_tr, g_full)):
    check_grads(f"heavy, step {i}", got, want)
  print(f"[8 heavy] ms_heavy's scene (random_3d_gaussians, scale_factor 4, alpha "
        f"0.75-0.99) {args.n} @{width}x{height}; {card}: "
        f"{int(mapping_h.total_overlaps)} overlaps in {k_h} slots, "
        f"{kept_h} kept ({kept_h / k_h:.4f}); saturated pixels "
        f"{float((full_h.image_weight >= config.saturate_threshold).double().mean()):.4f}; "
        f"render and gradients equal to the untruncated ones bit for bit, "
        f"raster_overflow False; three forward + backward steps through "
        f"TruncationGuard(config, margin_chunks=0), {guard_h.reprobes} "
        f"reprobes: {', '.join(f'{t:.3f}' for t in t_tr)} ms (the first "
        f"includes the probe); untruncated "
        f"{', '.join(f'{t:.3f}' for t in t_full)} ms")


def parallel_paths(args, dev, card, kernels, scene, camera):
  """Phase 9: the parallel path at full size (module docstring)."""
  import os
  import socket
  import torch.distributed as dist
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch import parallel
  from taichi_gaussian_rasterizer_tpu_torch.ops import lib
  from taichi_gaussian_rasterizer_tpu_torch.optim import (ParameterClass,
                                                          VisibilityAwareAdam)

  def reset_counts():
    for k in kernels.values():
      k.launch_count = 0

  def counts():
    return {name: k.launch_count for name, k in kernels.items()}

  width, height = args.size
  size = (width, height)
  n = scene.position.shape[0]
  near, far = camera.near_plane, camera.far_plane
  keys = [f.name for f in dataclasses.fields(tgr.Gaussians3D)]
  # a world of one rank on this card, from env:// as torchrun sets it
  with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
  os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                    WORLD_SIZE="1", LOCAL_RANK="0")
  mesh = parallel.make_mesh()
  print(f"[9 parallel] a world of {mesh.size} rank, {dist.get_backend()} on "
        f"{mesh.device}; {n} gaussians @{width}x{height}; {card}")
  try:
    # (a) dp_train_step: 2 cameras a rank, VisibilityAwareAdam
    config = tgr.RasterConfig(compute_visibility=True)
    t_moved = camera.T_camera_world.clone()
    t_moved[0, 3] += 0.02
    projections = torch.stack([camera.projection] * 2)
    t_cams = torch.stack([camera.T_camera_world, t_moved])
    targets = torch.rand((2, height, width, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))

    def fresh_params():
      return ParameterClass.create(
          {k: getattr(scene, k).detach().clone() for k in keys},
          {k: dict(lr=1e-3) for k in keys}, VisibilityAwareAdam)

    # the same step written out, without the group
    ref = fresh_params()
    leaves = {k: ref.tensors[k].detach().requires_grad_() for k in keys}
    ref_loss, ref_vis = 0.0, 0.0
    for i in range(2):
      cam = tgr.CameraParams(projections[i], t_cams[i], near, far, size)
      r = tgr.render_gaussians(tgr.Gaussians3D(**leaves), cam, config)
      mse = torch.mean((r.image - targets[i]) ** 2)
      (mse / 2).backward()
      ref_loss = ref_loss + mse.detach()
      ref_vis = ref_vis + r.point_visibility
    ref.step({k: leaves[k].grad for k in keys}, visibility=ref_vis)
    ref_loss = ref_loss / 2
    del leaves, r

    step = parallel.dp_train_step(mesh, config, size, local_batch=2,
                                  depth_range=(near, far))
    params = parallel.replicate(fresh_params(), mesh)
    blocks = parallel.shard_leading((projections, t_cams, targets), mesh)
    reset_counts()
    times, losses = [], []
    for i in range(3):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      params, loss = step(params, *blocks)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
      losses.append(float(loss))
      if i == 0:
        assert torch.equal(loss, ref_loss), (float(loss), float(ref_loss))
        for k in keys:
          assert torch.equal(params.tensors[k], ref.tensors[k]), k
          assert torch.equal(params.state[k].m, ref.state[k].m), k
          assert torch.equal(params.state[k].v, ref.state[k].v), k
        assert torch.equal(params.running_vis, ref.running_vis)
        assert torch.equal(params.total_weight, ref.total_weight)
    launches = counts()
    print(f"  dp_train_step(local_batch=2), RasterConfig(compute_visibility="
          f"True), VisibilityAwareAdam: launches in 3 steps {launches}")
    assert launches == {"raster_forward": 6, "raster_backward": 6,
                        "segment_sum": 12}, launches
    for k in keys:
      assert torch.isfinite(params.tensors[k]).all(), k
    print(f"  step 1 equal bit for bit to the same step written out without "
          f"the group (loss, parameters, moments, running visibility, total "
          f"weight); losses {', '.join(f'{x:.6f}' for x in losses)}; ms/step "
          f"{', '.join(f'{t:.3f}' for t in times)} (median "
          f"{statistics.median(times):.3f}); per step 2 forward, 2 backward and "
          f"4 segment-sum launches (a backward reduction and the forward "
          f"visibility's, per camera)")
    del params, ref, step, blocks, targets

    # (b) pp_project against project_to_image
    project = parallel.pp_project(mesh, config, size, (near, far))
    with torch.no_grad():
      got = project(scene, camera.projection, camera.T_camera_world)
      want = tgr.project_to_image(scene, camera, config)
      for label, a, b in zip(("points", "depth", "in_view"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), label
      pp_ms = host_ms(lambda: project(scene, camera.projection,
                                      camera.T_camera_world), 5)
      proj_ms = host_ms(lambda: tgr.project_to_image(scene, camera, config), 5)
    print(f"  pp_project equal to project_to_image bit for bit (points, depth, "
          f"in_view); {pp_ms:.3f} ms against {proj_ms:.3f} ms (host clock, "
          f"median of 5)")

    # (c) tp_rasterize's stripe body looped over 4 stripes
    config = tgr.RasterConfig()
    ts = config.tile_size
    features = scene.feature
    with torch.no_grad():
      points, depths, _ = tgr.project_to_image(scene, camera, config)
      depth = lib.ndc_depth(torch.clamp(depths, min=near), near, far)[:, 0]
      mapping = tgr.map_to_tiles(points, depth, size, config)
      assert not bool(mapping.overflow), "the frame's footprints clip"
      full = tgr.rasterize(points, depth, features, size, config)
      loads = parallel.stripe_row_loads(points, depth, size, config)
    partitions = {"equal": (height // (4 * ts),) * 4,
                  "balanced": parallel.balance_stripe_rows(loads, 4)}
    print(f"  the frame: {int(loads.sum())} overlaps over {len(loads)} tile "
          f"rows, footprint clip flag False")
    for label, rows in partitions.items():
      y0s, heights, _ = parallel.stripe_offsets_px(rows, ts)
      parts, ms = [], []
      with torch.no_grad():
        for i in range(4):
          parts.append(parallel.tp_rasterize_stripe(
              points, depth, features, config, size, rows, i))
          ms.append(host_ms(lambda: parallel.tp_rasterize_stripe(
              points, depth, features, config, size, rows, i), 3))
      image = parallel.assemble_stripes(torch.cat([p[0] for p in parts]),
                                        rows, ts)
      weight = parallel.assemble_stripes(torch.cat([p[1] for p in parts]),
                                         rows, ts)
      for name, got, want in (("image", image, full.image),
                              ("weight", weight, full.image_weight)):
        assert got.shape == want.shape, (name, got.shape)
        assert torch.allclose(got, want, rtol=1e-4, atol=2e-5), (
            f"{label} stripes: {name} max |diff| "
            f"{float((got - want).abs().max()):.3e}")
      same = ((image == full.image).all(-1) & (weight == full.image_weight))
      mx = max(float((image - full.image).abs().max()),
               float((weight - full.image_weight).abs().max()))
      stripe_loads = [int(loads[y // ts:(y + h) // ts].sum())
                      for y, h in zip(y0s, heights)]
      if label == "balanced" and rows == partitions["equal"]:
        label += " (the equal partition: this frame's row loads are even)"
      print(f"  tp_rasterize, {label} stripes: rows {list(heights)} px, "
            f"overlap loads {stripe_loads}, ms/stripe "
            f"{', '.join(f'{t:.3f}' for t in ms)} (host clock, median of 3); "
            f"assembled image and weight within rtol 1e-4 / atol 2e-5 of the "
            f"full frame: max |diff| {mx:.3e}, {float(same.double().mean()):.6f} "
            f"of pixels bit-equal")

    # (d) tp_train_step's stripe body looped over the same stripes
    config = tgr.RasterConfig(compute_point_heuristic=True)
    target = torch.rand((height, width, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(8))
    leaves = [points.detach().requires_grad_(),
              features.detach().requires_grad_(),
              points.new_zeros(n, 2, requires_grad=True),
              points.new_zeros(n, requires_grad=True)]
    out = tgr.rasterize(leaves[0], depth, leaves[1], size, config,
                        heuristic_sink=leaves[2], visibility_sink=leaves[3])
    full_loss = torch.sum((out.image - target) ** 2)
    want = torch.autograd.grad(full_loss, leaves)
    del out
    names = ("grad_points", "grad_features", "heuristics", "visibility")
    for label, rows in partitions.items():
      sums, ms = None, []
      for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part = parallel.tp_train_stripe(points, depth, features, target,
                                        config, size, n, rows, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        sums = part if sums is None else [a + b for a, b in zip(sums, part)]
      loss, *grads, dropped = sums
      assert int(dropped) == 0, int(dropped)
      loss_rel = abs(float(loss) / float(full_loss.detach()) - 1)
      assert loss_rel <= 1e-5, loss_rel
      rels = []
      for name, got, w in zip(names, grads, want):
        rel = float((got - w).abs().max() / w.abs().max())
        assert rel <= 1e-3, (label, name, rel)
        rels.append(f"{name} {rel:.3e}")
      print(f"  tp_train_step, {label} stripes, local_points {n}: 0 dropped; "
            f"loss relative diff {loss_rel:.3e}; max |diff| / max |full| "
            f"{', '.join(rels)}; ms/stripe {', '.join(f'{t:.3f}' for t in ms)}")
  finally:
    dist.destroy_process_group()


def hold_forward_tiles(label, points, features, mapping, config, size, ids,
                       image, weight):
  """The kernel's image and weight on the tiles `ids` against the plain
  version's (forward tolerance, blending). Returns the max |diff|."""
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import forward, tiles
  ids_dev = ids.to(points.device)
  inside = tiles.image_to_tiles(
      torch.ones(size[1], size[0], 1, device=points.device), mapping.tile_shape,
      config.tile_size)[ids_dev] > 0
  got = tiles.image_to_tiles(torch.cat([image, weight[..., None]], -1),
                             mapping.tile_shape, config.tile_size)[ids_dev]
  want_img, want_w = forward.rasterize_tiles_plain(points, features, mapping,
                                                   config, tile_ids=ids.tolist())
  return check_close(label, got, torch.cat([want_img, want_w[:, None]], 1)
                     * inside, blending=True)


def hold_backward_tiles(label, bw, ids):
  """The backward kernel's slot rows of the tiles `ids` against the plain
  version's (backward tolerance). Returns (the kernel's rows, max |diff|)."""
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import backward
  mapping = bw[2]
  slots = backward.rasterize_backward(*bw)
  want = backward.raster_backward_plain(*bw, tile_ids=ids.tolist())
  sel = torch.zeros(slots.shape[1], dtype=torch.bool, device=slots.device)
  for start, end in mapping.tile_ranges[ids.to(slots.device)].tolist():
    sel[start:end] = True
  return slots, check_rows(label, slots[:, sel], want[:, sel])


def feature_field(args, dev, card, kernels, scene, camera):
  """Phase 10: the feature-field frame at full size (module docstring).
  Returns the JSON line's entry of each kernel, measured on this frame."""
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
      backward, bounds, forward, reduce, reduce_slots_by_point, tiles)

  def reset_counts():
    for k in kernels.values():
      k.launch_count = 0

  def counts():
    return {name: k.launch_count for name, k in kernels.items()}

  width, height = args.size
  size = (width, height)
  n = scene.position.shape[0]
  channels = 32
  config = tgr.RasterConfig()
  gen = torch.Generator(device=dev).manual_seed(10)
  field = dataclasses.replace(
      scene, feature=torch.rand((n, channels), generator=gen, device=dev))
  blended = channels + 2
  print(f"[10 feature field] {n} gaussians @{width}x{height}, {channels} raw "
        f"channels (use_sh=False) + render_depth: {blended} blended; "
        f"RasterConfig(); {card}")

  # serving: five renders
  reset_counts()
  frame_ms = []
  for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = tgr.render_gaussians(field, camera, config, render_depth=True)
    torch.cuda.synchronize()
    frame_ms.append((time.perf_counter() - t0) * 1e3)
  assert counts() == {"raster_forward": 5, "raster_backward": 0,
                      "segment_sum": 0}, counts()
  assert r.image.shape == (height, width, channels)
  for name in ("image", "image_weight", "depth", "depth_var"):
    assert torch.isfinite(getattr(r, name)).all(), name

  # training: five steps of loss sum(image * G) + sum(depth * G_d)
  params = {f.name: getattr(field, f.name).detach().clone().requires_grad_()
            for f in dataclasses.fields(tgr.Gaussians3D)}
  gen_g = torch.Generator(device=dev).manual_seed(11)
  g_image = torch.randn((height, width, channels), generator=gen_g, device=dev)
  g_depth = torch.randn((height, width), generator=gen_g, device=dev)
  lr = 1e-6
  torch.cuda.reset_peak_memory_stats()
  step_ms = []
  for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt = tgr.render_gaussians(tgr.Gaussians3D(**params), camera, config,
                              render_depth=True)
    ((rt.image * g_image).sum() + (rt.depth * g_depth).sum()).backward()
    with torch.no_grad():
      for p in params.values():
        p -= lr * p.grad
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
    grads = {name: p.grad for name, p in params.items()}
    check_grads("feature-field step", grads)
    for p in params.values():
      p.grad = None
  launches = counts()
  peak = torch.cuda.max_memory_allocated() / 2**30
  assert launches == {"raster_forward": 10, "raster_backward": 5,
                      "segment_sum": 5}, launches
  print(f"  launches in 5 renders and 5 training steps: {launches}; finite, "
        f"non-zero gradients on all five tensors at every step")
  print(f"  ms/frame median {statistics.median(frame_ms):.3f} (5 renders: "
        f"{', '.join(f'{t:.3f}' for t in frame_ms)}); ms/step median "
        f"{statistics.median(step_ms):.3f} (5 steps: "
        f"{', '.join(f'{t:.3f}' for t in step_ms)}); peak device memory in "
        f"the steps {peak:.2f} GiB")
  del rt, grads, params

  # the frame's kernel inputs, as render_projected builds them
  with torch.no_grad():
    points, depths, _ = tgr.project_to_image(field, camera, config)
    feats = torch.cat([depths, depths * depths, field.feature], 1)
    _, mapping = project_and_map(field, camera, config)
    image, weight = forward.rasterize_forward(points, feats, mapping, size, config)
    assert torch.equal(image[..., 2:], r.image), "the render's image differs"
    n_tiles = mapping.tile_ranges.shape[0]
    ids = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(66))[:64]

    def hold_forward(label, f, img, w):
      return hold_forward_tiles(label, points, f, mapping, config, size, ids,
                                img, w)

    def hold_backward(label, bw):
      return hold_backward_tiles(label, bw, ids)

    fwd_err = hold_forward(f"64 seeded tiles, F = {blended} forward vs plain",
                           feats, image, weight)
    g_blend = torch.randn((height, width, blended), generator=gen_g, device=dev)
    bw = (points, feats, mapping, config, image, weight, g_blend,
          torch.zeros_like(weight))
    slots, bwd_err = hold_backward(f"64 seeded tiles, F = {blended} backward "
                                   f"vs plain", bw)
    assert torch.equal(slots, backward.rasterize_backward(*bw)), "two runs differ"
    keys, order = torch.sort(mapping.overlap_to_point, stable=True)
    grouped = slots.index_select(1, order)
    storage = slots.T      # the backward's slot-major rows, (K, R)
    assert storage.is_contiguous()
    seg_err = check_segment_sums(
        f"whole frame, point-sum kernel vs plain ({slots.shape[0]} rows)",
        reduce.point_sums_cuda(storage, order, mapping.point_offsets, n).T,
        reduce.segment_sums_plain(keys, grouped, n))

    rows = 6 + 3 + 128
    wide = torch.randn((slots.shape[1], rows), generator=gen_g, device=dev).T
    reset_counts()
    sums = reduce_slots_by_point(wide, mapping)
    assert counts()["segment_sum"] == 1, counts()
    wide_grouped = wide.index_select(1, order)
    assert torch.equal(sums, reduce.segment_sums_cuda(
        wide_grouped, mapping.point_offsets, n).T), "differs from the gathered sums"
    check_segment_sums(f"whole frame, {rows} slot-major rows in one launch vs "
                       f"plain, bit for bit the gathered segment sums", sums.T,
                       reduce.segment_sums_plain(keys, wide_grouped, n))
    del wide, wide_grouped, sums

    k = int(mapping.total_overlaps)
    work = bounds.raster_work(points, mapping, config, size)
    fwd_ms = cuda_ms(lambda: forward.rasterize_forward(points, feats, mapping,
                                                       size, config), reps=10)
    fwd_plain_ms = cuda_ms(lambda: forward.rasterize_tiles_plain(
        points, feats, mapping, config), reps=1)
    bwd_ms = cuda_ms(lambda: backward.rasterize_backward(*bw), reps=5)
    bwd_plain_ms = cuda_ms(lambda: backward.raster_backward_plain(*bw), reps=1)
    red_ms = cuda_ms(lambda: reduce_slots_by_point(slots, mapping), reps=5)
    seg_ms = cuda_ms(lambda: reduce.point_sums_cuda(
        storage, order, mapping.point_offsets, n), reps=20)
    seg_plain_ms = cuda_ms(lambda: reduce.segment_sums_plain(
        keys, slots.index_select(1, order), n), reps=5)
    sums = torch.zeros((n + 1, grouped.shape[0]), device=dev)
    keys64, rows_t = keys.to(torch.int64), grouped.T
    seg_library_ms = cuda_ms(lambda: sums.index_add_(0, keys64, rows_t), reps=5)
    fwd_bound = bounds.forward_bound(work, n, blended, k, n_tiles, size,
                                     config.antialias)
    bwd_bound = bounds.backward_bound(work, n, blended, k, n_tiles, size,
                                      config.antialias, False, False)
    seg_bound = bounds.segment_sum_bound(grouped.shape[0], k, n)
    print(f"  F = {blended} (CUDA events, whole frame): forward kernel "
          f"{fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
          f"{bound_line(fwd_bound, fwd_ms)}; backward kernel {bwd_ms:.4f} ms "
          f"({slots.shape[0]} rows), plain {bwd_plain_ms:.4f} ms, "
          f"{bound_line(bwd_bound, bwd_ms)}; reduction (sort + point sums) "
          f"{red_ms:.4f} ms; point-sum kernel {seg_ms:.4f} ms, plain (gather "
          f"and index_add_) {seg_plain_ms:.4f} ms, index_add_ alone "
          f"{seg_library_ms:.4f} ms, {bound_line(seg_bound, seg_ms)}")
    del slots, storage, grouped, sums, rows_t, bw

  # how the kernels' times grow with F: one serving render and one
  # training step through the entry points, then the kernels alone
  for f in (17, 64, 128):
    scene_f = dataclasses.replace(
        scene, feature=torch.rand((n, f), generator=gen, device=dev))
    with torch.no_grad():
      rf = tgr.render_gaussians(scene_f, camera, config)
      assert rf.image.shape == (height, width, f)
      assert torch.isfinite(rf.image).all()
    leaves = {name: getattr(scene_f, name).detach().requires_grad_()
              for name in ("position", "feature")}
    rg = tgr.render_gaussians(dataclasses.replace(scene_f, **leaves), camera,
                              config)
    (rg.image * torch.randn((height, width, f), generator=gen_g,
                            device=dev)).sum().backward()
    for name, leaf in leaves.items():
      assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0, name
    del rg, leaves
    with torch.no_grad():
      ff = scene_f.feature
      image_f, weight_f = forward.rasterize_forward(points, ff, mapping, size,
                                                    config)
      hold_forward(f"F = {f}, 64 seeded tiles, forward vs plain", ff, image_f,
                   weight_f)
      bw_f = (points, ff, mapping, config, image_f, weight_f,
              torch.randn((height, width, f), generator=gen_g, device=dev),
              torch.zeros_like(weight_f))
      hold_backward(f"F = {f}, 64 seeded tiles, backward vs plain", bw_f)
      f_ms = cuda_ms(lambda: forward.rasterize_forward(points, ff, mapping,
                                                       size, config), reps=5)
      b_ms = cuda_ms(lambda: backward.rasterize_backward(*bw_f), reps=3)
      f_bound = bounds.forward_bound(work, n, f, k, n_tiles, size,
                                     config.antialias)
      b_bound = bounds.backward_bound(work, n, f, k, n_tiles, size,
                                      config.antialias, False, False)
    print(f"  F = {f}: a serving render and a training step through "
          f"render_gaussians, finite; forward kernel {f_ms:.4f} ms, "
          f"{bound_line(f_bound, f_ms)}; backward kernel {b_ms:.4f} ms, "
          f"{bound_line(b_bound, b_ms)} (CUDA events)")
    del image_f, weight_f, bw_f, scene_f

  return {
      "raster_forward": (launches["raster_forward"], fwd_err, fwd_ms,
                         fwd_plain_ms, fwd_bound, None),
      "raster_backward": (launches["raster_backward"], bwd_err, bwd_ms,
                          bwd_plain_ms, bwd_bound, None),
      "segment_sum": (launches["segment_sum"], seg_err, seg_ms, seg_plain_ms,
                      seg_bound, seg_library_ms),
  }


def plain_optimizer(fn):
  """fn() with every CUDA group of `ParameterClass.step` stepped by the
  plain passes on the card, in place of the kernel."""
  from taichi_gaussian_rasterizer_tpu_torch.optim import group_step
  on_kernel = group_step.step_group_cuda
  group_step.step_group_cuda = group_step.step_group_plain
  try:
    return fn()
  finally:
    group_step.step_group_cuda = on_kernel


def max_gap(pairs) -> float:
  """The largest |a - b| over tensor pairs, 0 when each pair is equal bit
  for bit."""
  return max(0.0 if torch.equal(a, b) else float((a - b).abs().nan_to_num(1.0).max())
             for a, b in pairs)


# every instance of the optimizer kernel:
# (rule, kind, visibility_aware, point_lr, mask_lr, dtype)
OPTIM_CASES = list(itertools.product(
    ("adam", "laprop"), ("scalar", "vector", "local_vector"), (False, True),
    (False, True), (False, True), (torch.float32, torch.float64)))


def optim_case_params(n, d, case, device, seed=0):
  """Two groups: `x` (N, D) of the case's kind with its optional rates,
  and `a` (N, 1) scalar with other betas and no bias correction; `aux`
  is not optimized."""
  from taichi_gaussian_rasterizer_tpu_torch.optim import (OptimizerSpec,
                                                          ParameterClass)
  rule, kind, visibility_aware, point_lr, mask_lr, dtype = case
  rng = np.random.default_rng(seed)
  tensors = {"x": torch.tensor(rng.normal(size=(n, d)), dtype=dtype),
             "a": torch.tensor(rng.normal(size=(n, 1)), dtype=dtype),
             "aux": torch.zeros(n, dtype=dtype)}
  groups = {"x": dict(lr=0.1, type=kind),
            "a": dict(lr=0.05, type="scalar", betas=(0.8, 0.99),
                      bias_correction=False)}
  if point_lr:
    groups["x"]["point_lr"] = torch.tensor(rng.uniform(0.5, 1.5, n),
                                           dtype=torch.float32, device=device)
  if mask_lr:
    groups["x"]["mask_lr"] = torch.tensor(rng.uniform(0.5, 1.5, d),
                                          dtype=torch.float32, device=device)
  return ParameterClass.create(
      {k: v.to(device) for k, v in tensors.items()}, groups,
      optimizer=OptimizerSpec(kernel=rule, visibility_aware=visibility_aware))


def optim_case_inputs(n, d, steps, device, seed=1):
  """Per step: gradients (NaN where the point is not visible, which the
  step must not read through), visibility with zeros, fractional weights
  and a well-conditioned basis."""
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(steps):
    vis = rng.uniform(0.0, 3.0, n) * (rng.uniform(size=n) > 0.3)
    grads = {"x": torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32),
             "a": torch.tensor(rng.normal(size=(n, 1)), dtype=torch.float32)}
    for g in grads.values():
      g[vis == 0] = float("nan")
    basis = rng.normal(size=(n, d, d)) * 0.3 + 2.0 * np.eye(d)
    out.append(dict(grads={k: g.to(device) for k, g in grads.items()},
                    vis=torch.tensor(vis, dtype=torch.float32, device=device),
                    weight=torch.tensor(vis / 1.5, dtype=torch.float32,
                                        device=device),
                    basis=torch.tensor(basis, dtype=torch.float32, device=device)))
  return out


def optim_case_steps(params, inputs, kind):
  for s in inputs:
    kw = dict(basis=s["basis"]) if kind == "local_vector" else {}
    if params.optimizer.visibility_aware:
      params.step(s["grads"], visibility=s["vis"], **kw)
    else:
      params.step(s["grads"], weight=s["weight"], **kw)
  return params


def optim_kernel_against_plain(case, device, n, d, steps):
  """`steps` steps of one instance (an entry of OPTIM_CASES) through the
  kernel and through the plain passes on `device`, from the same start
  on the same inputs. Asserts that the plain steps launch nothing, that
  the parameters and moments keep their dtype, that the shared state
  (total_weight, running_vis) is the same bit for bit, and that points
  never stepped and the tensor not optimized keep their start, bit for
  bit. Returns the kernel's launches (the count set to 0 just before)
  and, for scalar and for vector groups, the largest |kernel - plain|
  over param, m and v, over the largest |plain|."""
  from taichi_gaussian_rasterizer_tpu_torch.optim import group_step
  kind, dtype = case[1], case[-1]
  inputs = optim_case_inputs(n, d, steps, device)
  group_step.OPTIM_STEP.launch_count = 0
  kernel = optim_case_steps(optim_case_params(n, d, case, device), inputs, kind)
  launches = group_step.OPTIM_STEP.launch_count
  plain = plain_optimizer(lambda: optim_case_steps(
      optim_case_params(n, d, case, device), inputs, kind))
  assert group_step.OPTIM_STEP.launch_count == launches
  worst = {"scalar": 0.0, "vector": 0.0}
  for k in ("x", "a"):
    group = "vector" if kind != "scalar" and k == "x" else "scalar"
    for got, want in ((kernel.tensors[k], plain.tensors[k]),
                      (kernel.state[k].m, plain.state[k].m),
                      (kernel.state[k].v, plain.state[k].v)):
      assert got.dtype == want.dtype == dtype, (k, got.dtype, want.dtype)
      worst[group] = max(worst[group],
                         max_gap([(got, want)]) / float(want.abs().max()))
  torch.testing.assert_close(kernel.total_weight, plain.total_weight, rtol=0, atol=0)
  torch.testing.assert_close(kernel.running_vis, plain.running_vis, rtol=0, atol=0)
  start = optim_case_params(n, d, case, device)
  never = plain.total_weight == 0
  assert never.any()
  assert torch.equal(kernel.tensors["x"][never], start.tensors["x"][never])
  assert torch.equal(kernel.tensors["aux"], start.tensors["aux"])
  return launches, worst


def optimizer_instances(dev):
  """Phase 12: the optimizer kernel (csrc/optim.cu) against the plain passes
  on the card, every instance at small N (module docstring)."""
  n, d, steps = 20011, 3, 3
  launches, worst = 0, {"scalar": 0.0, "vector": 0.0}
  for case in OPTIM_CASES:
    case_launches, case_worst = optim_kernel_against_plain(case, dev, n, d, steps)
    assert case_launches == 2 * steps, (case, case_launches)
    launches += case_launches
    worst = {k: max(worst[k], case_worst[k]) for k in worst}
  print(f"  {len(OPTIM_CASES)} instances (adam and laprop; scalar, vector, "
        f"local_vector; visibility-aware, point_lr, mask_lr each on and off; "
        f"float32 and float64), {steps} steps at N = {n}: {launches} launches "
        f"(one a group a step); scalar groups' largest |diff| over the largest "
        f"|plain| {worst['scalar']:.3e} (0: bit for bit), vector groups' "
        f"{worst['vector']:.3e} (tolerance {TOL_OPTIM_VECTOR:.0e}: the squared "
        f"norm added in another order than torch.sum's)")
  assert worst["scalar"] == 0.0 and worst["vector"] <= TOL_OPTIM_VECTOR, worst


def optimizer_widths(dev, points: int = 6_100_000):
  """Phase 12's second part: the cells' widths at the benchmark's 6.1M
  points, and the training cells' whole steps. Returns the JSON line's
  numbers for the bicycle6m step: its launches, its largest |kernel -
  plain| over param, m and v, the kernel's and the plain step's ms and
  the bound."""
  from taichi_gaussian_rasterizer_tpu_torch.optim import (
      FractionalAdam, ParameterClass, group_step)
  from taichi_gaussian_rasterizer_tpu_torch.optim.kernels import MomentState

  kernel = group_step.OPTIM_STEP

  # the cells' widths at the benchmark's 6.1M points, a scalar group each
  gen = torch.Generator(device=dev).manual_seed(23)
  lr = torch.tensor(1e-3, device=dev)
  for d in (1, 3, 4, 48, 128):
    w = torch.rand(points, generator=gen, device=dev) * 2 \
        * (torch.rand(points, generator=gen, device=dev) > 0.1)
    total = w + 2.0
    start = [torch.randn((points, d), generator=gen, device=dev) * s for s in (1.0, 0.01)]
    start.append(torch.rand((points, d), generator=gen, device=dev) * 1e-4)
    grad = torch.randn((points, d), generator=gen, device=dev)
    out = {}
    for label, fn in (("kernel", group_step.step_group_cuda),
                      ("plain", group_step.step_group_plain)):
      p, m, v = (t.clone() for t in start)
      kernel.launch_count = 0
      args = (p, grad, MomentState(m, v), w, total, lr, "adam", "scalar",
              (0.9, 0.999), 1e-16, True)
      fn(*args)
      out[label] = [t.clone() for t in (p, m, v)] + [kernel.launch_count]
      # then timed on the same buffers, stepping them on
      out[label + "_ms"] = cuda_ms(lambda: fn(*args), reps=10 if label == "kernel" else 3)
    gap = max_gap(zip(out["kernel"][:3], out["plain"][:3]))
    still = w == 0
    assert torch.equal(out["kernel"][0][still], start[0][still])
    assert out["kernel"][3] == 1 and out["plain"][3] == 0
    nbytes = (28 * d + 8) * points
    print(f"  {points} x {d}: |kernel - plain| max {gap:.3e}, weight-0 rows "
          f"unchanged; 1 launch; kernel {out['kernel_ms']:.4f} ms, bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e9:.3f} GB), "
          f"share {nbytes / HBM_BYTES_PER_S * 1e3 / out['kernel_ms']:.3f}; "
          f"plain {out['plain_ms']:.3f} ms")
    assert gap == 0.0, (d, gap)
    del out, start, grad, p, m, v
    torch.cuda.empty_cache()

  # whole steps of the training cells: FractionalAdam, unit weights
  widths = {"position": 3, "log_scaling": 3, "rotation": 4, "alpha_logit": 1,
            "feature": 48}
  entry = None
  for label, groups in (("bicycle6m", widths),
                        ("feat3dgs-bicycle6m", {**widths, "semantic_feature": 128})):
    params = ParameterClass.create(
        {k: torch.randn((points, w), generator=gen, device=dev)
         for k, w in groups.items()}, {k: {"lr": 1e-3} for k in groups},
        optimizer=FractionalAdam)
    grads = {k: torch.randn_like(v) for k, v in params.tensors.items()}
    ones = torch.ones(points, device=dev)
    # a first step takes the moments and the total weight away from 0
    params.step({k: torch.randn_like(v) for k, v in grads.items()}, weight=ones)
    twin = params[torch.arange(points, device=dev)]   # a copy of every tensor
    kernel.launch_count = 0
    params.step(grads, weight=ones)
    step_launches = kernel.launch_count
    plain_optimizer(lambda: twin.step(grads, weight=ones))
    assert kernel.launch_count == step_launches
    err = max_gap([(params.total_weight, twin.total_weight)] + [
        pair for k in groups
        for pair in ((params.tensors[k], twin.tensors[k]),
                     (params.state[k].m, twin.state[k].m),
                     (params.state[k].v, twin.state[k].v))])
    del twin
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: params.step(grads, weight=ones), reps=10)
    above = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    plain_ms = plain_optimizer(
        lambda: cuda_ms(lambda: params.step(grads, weight=ones), reps=3))
    plain_above = torch.cuda.max_memory_allocated() - base
    nbytes = (28 * sum(groups.values()) + 12) * points
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  {label} step, {points} x {sum(groups.values())} in "
          f"{len(groups)} groups: {step_launches} launches; |kernel - plain| "
          f"max {err:.3e} over param, m, v and the total weight (one step "
          f"from the same state); kernel {ms:.4f} ms, bound {bound:.4f} ms "
          f"({nbytes / 1e9:.3f} GB), share {bound / ms:.3f}; plain "
          f"{plain_ms:.3f} ms; device memory above the state "
          f"{above / 2**30:.3f} GiB (plain {plain_above / 2**30:.3f})")
    assert step_launches == len(groups), step_launches
    assert err == 0.0, (label, err)
    if entry is None:
      entry = (step_launches, err, ms, plain_ms,
               dict(ms=bound, bound_by="bytes"), None)
    del params, grads
    torch.cuda.empty_cache()
  return entry


def tile_sizes(args, dev, card, kernels, scene, camera):
  """Phase 11: phase 3's scene at tile sizes that are not whole warps (12)
  or larger than a block (40), RGB and the 34-channel feature field
  (module docstring)."""
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
      backward, bounds, forward)

  width, height = args.size
  size = (width, height)
  n = scene.position.shape[0]
  field = dataclasses.replace(scene, feature=torch.rand(
      (n, 32), generator=torch.Generator(device=dev).manual_seed(12), device=dev))
  gen_g = torch.Generator(device=dev).manual_seed(13)
  for tile_size in (12, 40):
    config = tgr.RasterConfig(tile_size=tile_size)
    for label, gaussians, kw in (("RGB", scene, {}),
                                 ("F = 34", field,
                                  dict(use_sh=False, render_depth=True))):
      for k in kernels.values():
        k.launch_count = 0
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      with torch.no_grad():
        r = tgr.render_gaussians(gaussians, camera, config, **kw)
      torch.cuda.synchronize()
      frame_ms = (time.perf_counter() - t0) * 1e3
      assert torch.isfinite(r.image).all() and torch.isfinite(r.image_weight).all()
      params = {f.name: getattr(gaussians, f.name).detach().clone().requires_grad_()
                for f in dataclasses.fields(tgr.Gaussians3D)}
      g_image = torch.randn(tuple(r.image.shape), generator=gen_g, device=dev)
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      rt = tgr.render_gaussians(tgr.Gaussians3D(**params), camera, config, **kw)
      loss = (rt.image * g_image).sum()
      if kw:
        loss = loss + rt.depth.sum()
      loss.backward()
      torch.cuda.synchronize()
      step_ms = (time.perf_counter() - t0) * 1e3
      check_grads(f"tile {tile_size} {label} step",
                  {name: p.grad for name, p in params.items()})
      launches = {name: k.launch_count for name, k in kernels.items()}
      assert launches == {"raster_forward": 2, "raster_backward": 1,
                          "segment_sum": 1}, launches
      del rt, params, loss
      with torch.no_grad():
        points, mapping = project_and_map(gaussians, camera, config)
        feats = gaussians.feature
        if kw:
          _, depths, _ = tgr.project_to_image(gaussians, camera, config)
          feats = torch.cat([depths, depths * depths, feats], 1)
        f = feats.shape[1]
        image, weight = forward.rasterize_forward(points, feats, mapping, size,
                                                  config)
        ids = torch.randperm(mapping.tile_ranges.shape[0],
                             generator=torch.Generator().manual_seed(67))[:64]
        hold_forward_tiles(f"tile {tile_size} {label}: 64 seeded tiles, forward "
                           f"vs plain", points, feats, mapping, config, size,
                           ids, image, weight)
        bw = (points, feats, mapping, config, image, weight,
              torch.randn((height, width, f), generator=gen_g, device=dev),
              torch.zeros_like(weight))
        hold_backward_tiles(f"tile {tile_size} {label}: 64 seeded tiles, "
                            f"backward vs plain", bw, ids)
        fwd_ms = cuda_ms(lambda: forward.rasterize_forward(
            points, feats, mapping, size, config), reps=5)
        bwd_ms = cuda_ms(lambda: backward.rasterize_backward(*bw), reps=3)
        work = bounds.raster_work(points, mapping, config, size)
        k = int(mapping.total_overlaps)
        n_tiles = mapping.tile_ranges.shape[0]
        fwd_bound = bounds.forward_bound(work, n, f, k, n_tiles, size,
                                         config.antialias)
        bwd_bound = bounds.backward_bound(work, n, f, k, n_tiles, size,
                                          config.antialias, False, False)
      print(f"  tile {tile_size}, {label}: launches in a render and a training "
            f"step {launches}; render {frame_ms:.3f} ms, step {step_ms:.3f} ms "
            f"(host clock, one each); forward kernel {fwd_ms:.4f} ms, "
            f"{bound_line(fwd_bound, fwd_ms)}; backward kernel {bwd_ms:.4f} ms, "
            f"{bound_line(bwd_bound, bwd_ms)} (CUDA events; {card})")
      del image, weight, bw, points, mapping, feats


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
  from taichi_gaussian_rasterizer_tpu_torch.examples import (
      fit_image_gaussians as fit2d)
  from taichi_gaussian_rasterizer_tpu_torch.ops import sh as sh_ops
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
      backward, bounds, forward, reduce, reduce_slots_by_point, tiles)
  from taichi_gaussian_rasterizer_tpu_torch.optim import group_step
  from taichi_gaussian_rasterizer_tpu_torch.utils.cuda_build import load_all
  from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import (
      random_3d_gaussians)

  torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's einsum
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda")
  # segment_sum.cu's entry point on the main path: the one-pass reduction
  kernels = {"raster_forward": forward.RASTER_FORWARD,
             "raster_backward": backward.RASTER_BACKWARD,
             "segment_sum": reduce.POINT_SUMS}

  def reset_counts():
    for k in kernels.values():
      k.launch_count = 0

  def counts():
    return {name: k.launch_count for name, k in kernels.items()}
  device_name = torch.cuda.get_device_name(0)
  card = card_line()

  def plain_image(points, features, mapping, size, config, tile_ids=None):
    """The plain version's (tiles, F + 1, P) output, weight in row F."""
    img, w = forward.rasterize_tiles_plain(points, features, mapping, config,
                                           tile_ids=tile_ids)
    return torch.cat([img, w[:, None]], 1)

  # ---- phase 1: build --------------------------------------------------
  print(f"[1 build] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
  t0 = time.perf_counter()
  load_all(list(kernels.values()) + [sh_ops.SH_FORWARD, group_step.OPTIM_STEP])
  sh_ops.SH_BACKWARD.load()   # the same library
  reduce.SEGMENT_SUM.load()   # the same library as the one-pass reduction
  print(f"[1 build] nvcc built the five sources for sm_90a in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
  for name, k in kernels.items():
    print(f"  {KERNELS[name][0]}: ptxas: {ptxas_summary(k.build_log)}")
  print(f"  {CSRC}sh.cu: ptxas: {ptxas_summary(sh_ops.SH_FORWARD.build_log)}")
  print(f"  {CSRC}optim.cu: ptxas: "
        f"{ptxas_summary(group_step.OPTIM_STEP.build_log)}")

  with torch.no_grad():
    # ---- phase 2: kernel against plain, all four modes -----------------
    frame2 = saturating_frame(dev)
    size2, n2, config2 = frame2.size, frame2.n, frame2.config
    points2, mapping2, features2 = frame2.points, frame2.mapping, frame2.features
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

    # ---- phase 2b: backward kernels against plain -----------------------
    g_img2, g_w2 = frame2.g_image, frame2.g_weight
    print(f"[2b backward vs plain] phase 2's scene, seeded cotangent image "
          f"and weight")
    k2 = int(mapping2.total_overlaps)
    tiles2 = mapping2.tile_ranges.shape[0]
    for antialias in (False, True):
      work2 = bounds.raster_work(points2, mapping2,
                                 config2.replace(antialias=antialias), size2)
      for extra in (False, True):
        cfg = config2.replace(antialias=antialias)
        image, weight = forward.rasterize_forward(points2, features2, mapping2,
                                                  size2, cfg)
        bw2 = (points2, features2, mapping2, cfg, image, weight, g_img2, g_w2,
               extra, extra)
        got = backward.rasterize_backward(*bw2)
        torch.cuda.synchronize()
        want = backward.raster_backward_plain(*bw2)
        label = (f"{'antialias' if antialias else 'conic'}"
                 f"{' + heuristic + visibility rows' if extra else ''}")
        check_rows(label, got, want)
        again = backward.rasterize_backward(*bw2)
        assert torch.equal(got, again), f"{label}: two backward runs differ"
        k_ms = cuda_ms(lambda: backward.rasterize_backward(*bw2), reps=20)
        p_ms = cuda_ms(lambda: backward.raster_backward_plain(*bw2), reps=2)
        b = bounds.backward_bound(work2, n2, 3, k2, tiles2, size2, antialias,
                                  extra, extra)
        print(f"    bitwise identical on a second run; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms; {bound_line(b, k_ms)}")
        if not antialias and not extra:
          slots2 = got
    keys2, order2 = torch.sort(mapping2.overlap_to_point, stable=True)
    grouped2 = slots2.index_select(1, order2)
    got = reduce.segment_sums_by_sorted_key(keys2, grouped2,
                                            mapping2.point_offsets, n2)
    check_segment_sums("segment sums of the conic rows", got,
                       reduce.segment_sums_plain(keys2, grouped2, n2))
    assert torch.equal(got, reduce.segment_sums_by_sorted_key(
        keys2, grouped2, mapping2.point_offsets, n2)), "two reductions differ"
    k_ms = cuda_ms(lambda: reduce.segment_sums_cuda(
        grouped2, mapping2.point_offsets, n2), reps=20)
    p_ms = cuda_ms(lambda: reduce.segment_sums_plain(keys2, grouped2, n2), reps=5)
    b = bounds.segment_sum_bound(grouped2.shape[0], k2, n2)
    print(f"    bitwise identical on a second run; kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms; {bound_line(b, k_ms)}")
    one_pass = reduce_slots_by_point(slots2, mapping2)
    assert torch.equal(one_pass, got.T), "one-pass reduction differs"
    r_ms = cuda_ms(lambda: reduce_slots_by_point(slots2, mapping2), reps=20)
    print(f"    one-pass reduction of the slot-major rows (sort + point sums) "
          f"equal to the gathered segment sums bit for bit; {r_ms:.4f} ms")

    # ---- phase 2c: forward visibility against plain ----------------------
    print(f"[2c forward visibility vs plain] phase 2's scene, "
          f"{mapping2.overlap_to_point.shape[0]} slots")
    for antialias in (False, True):
      for blending in (True, False):
        cfg = config2.replace(antialias=antialias, use_alpha_blending=blending)
        label = (f"{'blending' if blending else 'quantile'}/"
                 f"{'antialias' if antialias else 'conic'}")

        def vis_kernel():
          return forward.rasterize_forward(points2, features2, mapping2, size2,
                                           cfg, compute_visibility=True)

        def vis_plain():
          return forward.rasterize_tiles_plain(points2, features2, mapping2, cfg,
                                               visibility_image_size=size2)

        _, weight, vis = vis_kernel()
        torch.cuda.synchronize()
        check_close(f"{label} per-slot visibility", vis, vis_plain()[2], blending)
        assert torch.equal(vis, vis_kernel()[2]), f"{label}: two runs differ"
        if blending:
          per_point = reduce_slots_by_point(vis[None], mapping2)[:, 0]
          rel = abs(float(per_point.sum()) / float(weight.sum()) - 1)
          print(f"    sum of per-point visibility / sum of weight image - 1 = "
                f"{rel:.3e}")
          assert rel <= 1e-5, f"{label}: visibility identity off by {rel:.3e}"
        k_ms = cuda_ms(vis_kernel, reps=20)
        p_ms = cuda_ms(vis_plain, reps=3)
        b = bounds.forward_bound(
            bounds.raster_work(points2, mapping2, cfg, size2), n2, 3, k2,
            tiles2, size2, antialias, visibility=True)
        print(f"    bitwise identical on a second run; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms; {bound_line(b, k_ms)}")

    # ---- phase 2d: the forward's per-tile saturation front against plain --
    bins2 = mapping2.tile_ranges[:, 1] - mapping2.tile_ranges[:, 0]
    live2 = int((bins2 > 0).sum())
    print(f"[2d tile front vs plain] phase 2's scene, blending, {live2} "
          f"non-empty tiles of {tiles2}; {card}")
    for antialias in (False, True):
      cfg = config2.replace(antialias=antialias)

      def front_plain():
        return forward.rasterize_tiles_plain(points2, features2, mapping2, cfg,
                                             front_image_size=size2)

      *want_tiled, want_front = front_plain()
      want_tiled = torch.cat([want_tiled[0], want_tiled[1][:, None]], 1)
      for vis in (False, True):
        label = (f"{'antialias' if antialias else 'conic'}"
                 f"{' with visibility' if vis else ''}")

        def front_kernel():
          return forward.rasterize_forward(points2, features2, mapping2, size2,
                                           cfg, compute_visibility=vis,
                                           tile_front=True)

        image, weight, *_, front = front_kernel()
        torch.cuda.synchronize()
        assert torch.equal(front, front_kernel()[-1]), f"{label}: two runs differ"
        differ = front != want_front
        got_tiled = tiles.image_to_tiles(torch.cat([image, weight[..., None]], -1),
                                         mapping2.tile_shape, cfg.tile_size)
        image_differs = (got_tiled != want_tiled).flatten(1).any(1)
        n_differ = int(differ.sum())
        print(f"  {label}: {n_differ} tiles' fronts differ from plain (limit "
              f"{0.005 * live2:.1f}, 0.5% of the non-empty tiles), "
              f"{int((front > 0).sum())} tiles saturate; bitwise identical on a "
              f"second run")
        assert n_differ <= 0.005 * live2, f"{label}: {n_differ} fronts differ"
        assert bool(image_differs[differ].all()), (
            f"{label}: a front differs where the two images agree")
        k_ms = cuda_ms(front_kernel, reps=20)
        k0_ms = cuda_ms(lambda: forward.rasterize_forward(
            points2, features2, mapping2, size2, cfg, compute_visibility=vis),
            reps=20)
        p_ms = cuda_ms(front_plain, reps=3)
        print(f"    kernel with tile_front {k_ms:.4f} ms, without {k0_ms:.4f} "
              f"ms, plain {p_ms:.4f} ms")

    # ---- phase 3: the slice at full size -------------------------------
    width, height = args.size
    scene, camera = bench_scene(args.n, (width, height), dev)
    config = tgr.RasterConfig()
    print(f"[3 render] {args.n} gaussians @{width}x{height}, RGB, "
          f"RasterConfig() defaults")

    reset_counts()
    frame_ms = []
    for _ in range(5):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      r = tgr.render_gaussians(scene, camera, config)
      torch.cuda.synchronize()
      frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = counts()
    print(f"  launches in 5 renders: {launches}")
    assert launches == {"raster_forward": 5, "raster_backward": 0,
                        "segment_sum": 0}, launches

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
    fwd_err = check_close("64 seeded tiles, render vs plain",
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
    fwd_ms = cuda_ms(lambda: forward.rasterize_forward(
        points, features, mapping, (width, height), config), reps=10)
    fwd_front_ms = cuda_ms(lambda: forward.rasterize_forward(
        points, features, mapping, (width, height), config, tile_front=True),
        reps=10)
    fwd_plain_ms = cuda_ms(lambda: plain_image(points, features, mapping,
                                               (width, height), config), reps=1)
    work3 = bounds.raster_work(points, mapping, config, (width, height))
    fwd_bound = bounds.forward_bound(work3, args.n, 3, total, n_tiles,
                                     (width, height), config.antialias)
    print(f"  raster over the whole frame (CUDA events): kernel {fwd_ms:.4f} ms "
          f"({fwd_front_ms:.4f} ms with tile_front), "
          f"plain {fwd_plain_ms:.4f} ms; {bound_line(fwd_bound, fwd_ms)}; "
          f"{work3['evaluated']} (pixel, slot) pairs before the pixels stop, "
          f"{work3['boxed']} inside their threshold boxes, {work3['active']} "
          f"above the alpha threshold; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 4: the serving configuration ----------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    scene_sh = random_3d_gaussians(gen, args.n, camera, sh_degree=3)
    print(f"[4 serve] {args.n} gaussians @{width}x{height}, SH degree 3, "
          f"render_depth, render_median_depth")
    reset_counts()
    sh_launches = sh_ops.SH_FORWARD.launch_count
    sh_ms = []
    for _ in range(3):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      r = tgr.render_gaussians(scene_sh, camera, config, use_sh=True,
                               render_depth=True, render_median_depth=True)
      torch.cuda.synchronize()
      sh_ms.append((time.perf_counter() - t0) * 1e3)
    assert counts()["raster_forward"] == 6, counts()
    assert sh_ops.SH_FORWARD.launch_count == sh_launches + 3
    for field in ("image", "image_weight", "depth", "depth_var", "median_depth"):
      value = getattr(r, field)
      assert value.shape[:2] == (height, width), (field, value.shape)
      assert torch.isfinite(value).all(), field
    covered = r.image_weight > 0.5
    print(f"  launches {counts()['raster_forward']} in 3 renders; median depth "
          f"{float(r.median_depth[covered].median()):.3f}, blended depth "
          f"{float(r.depth[covered].median()):.3f} over {float(covered.float().mean()):.3f} "
          f"of pixels")
    print(f"  ms/frame median {statistics.median(sh_ms):.3f} "
          f"(3 renders: {', '.join(f'{t:.3f}' for t in sh_ms)})")
    sh_kernels(sh_ops, scene_sh.feature, scene_sh.position,
               camera.camera_position)

    # ---- phase 4b: serving with visibility and depth16 -----------------
    vis_config = config.replace(compute_visibility=True)
    print(f"[4b serve + visibility, depth16] {args.n} gaussians "
          f"@{width}x{height}, RGB, RasterConfig(compute_visibility=True)")

    def timed_renders(**kw):
      times = []
      for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = tgr.render_gaussians(scene, camera, vis_config, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
      return r, times

    for depth16 in (False, True):
      reset_counts()
      r, times = timed_renders(use_depth16=depth16)
      launches = counts()
      assert launches == {"raster_forward": 3, "raster_backward": 0,
                          "segment_sum": 3}, launches
      vis = r.point_visibility
      assert vis.shape == (args.n,) and torch.isfinite(vis).all()
      assert float(vis.min()) >= 0.0, float(vis.min())
      rel = abs(float(vis.sum()) / float(r.image_weight.sum()) - 1)
      assert rel <= 1e-5, f"visibility identity off by {rel:.3e}"
      label = "use_depth16=True" if depth16 else "full-depth keys"
      print(f"  {label}: launches in 3 renders {launches}; "
            f"{int(r.visible_mask.sum())} points visible; sum of visibility / "
            f"sum of weight image - 1 = {rel:.3e}")
      if depth16:
        _, mapping16 = project_and_map(scene, camera, config, use_depth16=True)
        assert int(mapping16.total_overlaps) == total, (
            int(mapping16.total_overlaps), total)
        mx, p = diff_stats(r.image, r_full.image)
        print(f"  overlaps {int(mapping16.total_overlaps)}, as with full-depth "
              f"keys; image against the full-depth render: max |diff| "
              f"{mx:.3e}, p99.99 |diff| {p:.3e} (quantized ties blend in "
              f"point order)")
        det = tgr.render_gaussians(scene, camera,
                                   vis_config.replace(deterministic=True),
                                   use_depth16=True)
        assert torch.equal(det.image, r_full.image), "deterministic depth16"
        print("  with deterministic=True (ties broken on the full depth) the "
              "image is the full-depth render's, bit for bit")
      else:
        r_full = r
      print(f"  ms/frame median {statistics.median(times):.3f} "
            f"(3 renders: {', '.join(f'{t:.3f}' for t in times)})")

    vis_ms = cuda_ms(lambda: forward.rasterize_forward(
        points, features, mapping, (width, height), config,
        compute_visibility=True), reps=10)
    slot_vis = forward.rasterize_forward(points, features, mapping,
                                         (width, height), config,
                                         compute_visibility=True)[2]
    red_vis_ms = cuda_ms(lambda: reduce_slots_by_point(slot_vis[None], mapping),
                         reps=10)
    map_ms = host_ms(lambda: project_and_map(scene, camera, config), 5)
    map16_ms = host_ms(lambda: project_and_map(scene, camera, config,
                                               use_depth16=True), 5)
    vis_bound = bounds.forward_bound(work3, args.n, 3, total, n_tiles,
                                     (width, height), config.antialias,
                                     visibility=True)
    print(f"  forward kernel with visibility {vis_ms:.4f} ms (without: "
          f"{fwd_ms:.4f}; {bound_line(vis_bound, vis_ms)}), per-point "
          f"reduction {red_vis_ms:.4f} ms (CUDA "
          f"events); projection + mapper {map_ms:.3f} ms with full-depth "
          f"keys, {map16_ms:.3f} ms with depth16 keys (host clock, median of 5)")

  # ---- phase 5: the training frame at full size --------------------------
  fields = [f.name for f in dataclasses.fields(tgr.Gaussians3D)]
  params = {name: getattr(scene, name).detach().clone().requires_grad_()
            for name in fields}
  g_image = torch.randn((height, width, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
  lr = 1e-6
  print(f"[5 train] {args.n} gaussians @{width}x{height}, RGB, RasterConfig(); "
        f"loss sum(image * G), G seeded normal; SGD lr {lr}")

  def sgd(grads):
    with torch.no_grad():
      for name, p in params.items():
        p -= lr * grads[name]

  torch.cuda.reset_peak_memory_stats()
  reset_counts()
  step_ms = []
  for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = tgr.render_gaussians(tgr.Gaussians3D(**params), camera, config)
    (r.image * g_image).sum().backward()
    grads = {name: p.grad for name, p in params.items()}
    sgd(grads)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
    for name, g in grads.items():
      assert torch.isfinite(g).all(), f"non-finite gradient of {name}"
      assert g.abs().sum() > 0, f"zero gradient of {name}"
      params[name].grad = None
  train_launches = counts()
  print(f"  launches in 5 steps: {train_launches}")
  assert all(v == 5 for v in train_launches.values()), train_launches
  print("  finite, non-zero gradients on "
        + ", ".join(f"{name} (max |g| {float(g.abs().max()):.3e})"
                    for name, g in grads.items()))
  train_peak = torch.cuda.max_memory_allocated() / 2**30

  with torch.no_grad():
    scene_now = tgr.Gaussians3D(**{k: v.detach() for k, v in params.items()})
    features = scene_now.feature
    points, mapping = project_and_map(scene_now, camera, config)
    image, weight = forward.rasterize_forward(points, features, mapping,
                                              (width, height), config)
    bw_args = (points, features, mapping, config, image, weight, g_image,
               torch.zeros_like(weight))
    slots = backward.rasterize_backward(*bw_args)
    print(f"  after the 5 steps: {int(mapping.total_overlaps)} overlaps in "
          f"{slots.shape[1]} candidate slots")
    n_tiles = mapping.tile_ranges.shape[0]
    ids = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(65))[:64]
    want = backward.raster_backward_plain(*bw_args, tile_ids=ids.tolist())
    sel = torch.zeros(slots.shape[1], dtype=torch.bool, device=dev)
    for start, end in mapping.tile_ranges[ids.to(dev)].tolist():
      sel[start:end] = True
    bwd_err = check_rows(f"64 seeded tiles ({int(sel.sum())} slots), backward "
                         f"kernel vs plain", slots[:, sel], want[:, sel])
    keys, order = torch.sort(mapping.overlap_to_point, stable=True)
    grouped = slots.index_select(1, order)
    seg_err = check_segment_sums(
        "whole frame, segment-sum kernel vs plain",
        reduce.segment_sums_cuda(grouped, mapping.point_offsets, args.n),
        reduce.segment_sums_plain(keys, grouped, args.n))
    assert torch.equal(reduce_slots_by_point(slots, mapping), reduce.segment_sums_cuda(
        grouped, mapping.point_offsets, args.n).T), "one-pass reduction differs"

    fwd_step_ms = host_ms(
        lambda: tgr.render_gaussians(scene_now, camera, config), 5)
    bwd_ms = cuda_ms(lambda: backward.rasterize_backward(*bw_args), reps=10)
    bwd_plain_ms = cuda_ms(lambda: backward.raster_backward_plain(*bw_args),
                           reps=1)
    red_ms = cuda_ms(lambda: reduce_slots_by_point(slots, mapping), reps=10)
    seg_ms = cuda_ms(lambda: reduce.segment_sums_cuda(
        grouped, mapping.point_offsets, args.n), reps=20)
    seg_plain_ms = cuda_ms(lambda: reduce.segment_sums_plain(
        keys, grouped, args.n), reps=5)
    # the one PyTorch call that computes the segment sums
    sums = torch.zeros((args.n + 1, grouped.shape[0]), device=dev)
    keys64, rows_t = keys.to(torch.int64), grouped.T
    seg_library_ms = cuda_ms(lambda: sums.index_add_(0, keys64, rows_t), reps=5)
    k5 = int(mapping.total_overlaps)
    work5 = bounds.raster_work(points, mapping, config, (width, height))
    bwd_bound = bounds.backward_bound(work5, args.n, 3, k5, n_tiles,
                                      (width, height), config.antialias,
                                      False, False)
    seg_bound = bounds.segment_sum_bound(grouped.shape[0], k5, args.n)
  step = statistics.median(step_ms)
  print(f"  ms/step median {step:.3f} (5 steps: "
        f"{', '.join(f'{t:.3f}' for t in step_ms)})")
  print(f"  step split: forward render {fwd_step_ms:.3f} ms (host clock, "
        f"median of 5, no graph); backward raster kernel {bwd_ms:.4f} ms; "
        f"reduction (sort + point sums) {red_ms:.4f} ms (CUDA "
        f"events); the rest -- autograd of projection and SH, the chain, "
        f"SGD and glue -- {step - fwd_step_ms - bwd_ms - red_ms:.3f} ms by "
        f"difference")
  print(f"  backward kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, "
        f"{bound_line(bwd_bound, bwd_ms)}; segment-sum kernel {seg_ms:.4f} "
        f"ms, plain {seg_plain_ms:.4f} ms, index_add_ {seg_library_ms:.4f} "
        f"ms, {bound_line(seg_bound, seg_ms)} (whole frame, CUDA events; "
        f"{slots.shape[0]} rows x {slots.shape[1]} slots); peak device memory "
        f"in the 5 steps {train_peak:.2f} GiB")

  # ---- phase 6: training mode -------------------------------------------
  print(f"[6 training mode] render_with_heuristics, same size")
  scene_now = tgr.Gaussians3D(**{k: v.detach() for k, v in params.items()})
  reset_counts()
  heur_ms = []
  for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads6, r = tgr.render_with_heuristics(
        lambda r: (r.image * g_image).sum(), scene_now, camera, config)
    with torch.no_grad():
      scene_now = tgr.Gaussians3D(**{
          name: getattr(scene_now, name) - lr * getattr(grads6, name)
          for name in fields})
    torch.cuda.synchronize()
    heur_ms.append((time.perf_counter() - t0) * 1e3)
  mode_launches = counts()
  assert all(v == 3 for v in mode_launches.values()), mode_launches
  assert torch.isfinite(r.point_heuristic).all() and (r.point_heuristic >= 0).all()
  assert torch.isfinite(r.point_visibility).all() and (r.point_visibility >= 0).all()
  assert all(torch.isfinite(getattr(grads6, name)).all() for name in fields)
  print(f"  launches in 3 steps: {mode_launches}; loss {float(loss):.4f}; "
        f"{int(r.visible_mask.sum())} points visible, prune cost max "
        f"{float(r.prune_cost.max()):.3e}, split score max "
        f"{float(r.split_score.max()):.3e}")
  print(f"  ms/step median {statistics.median(heur_ms):.3f} (3 steps: "
        f"{', '.join(f'{t:.3f}' for t in heur_ms)})")

  # ---- phase 7: the 2D trainer at full size -------------------------------
  target_size, n0, n_target, iters = (width, height), args.n // 2, args.n, 60
  print(f"[7 fit 2D] fit(synthetic_target({target_size}), n={n0}, "
        f"target={n_target}, total_iters={iters}, "
        f"config=RasterConfig(compute_point_heuristic=True), seed=0); epochs "
        f"{fit2d.make_epochs(iters, 10, 100)}")
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  history = []
  reset_counts()
  t0 = time.perf_counter()
  params2d, image2d = fit2d.fit(
      fit2d.synthetic_target(target_size), n=n0, target=n_target,
      total_iters=iters, config=tgr.RasterConfig(compute_point_heuristic=True),
      seed=0, device=dev, log=lambda msg: print(f"  {msg}"), history=history)
  torch.cuda.synchronize()
  fit_s = time.perf_counter() - t0
  fit_launches = counts()
  peak = torch.cuda.max_memory_allocated()
  print(f"  launches in {iters} steps: {fit_launches}; fit took {fit_s:.2f} s; "
        f"peak device memory {peak / 2**30:.2f} GiB, of it "
        f"{(peak - base) / 2**30:.2f} GiB above what earlier phases hold")
  assert all(v == iters for v in fit_launches.values()), fit_launches
  assert params2d.num_points == n_target, params2d.num_points
  rows = {f"{k}.{m}": getattr(s, m).shape[0]
          for k, s in params2d.state.items() for m in ("m", "v")}
  rows.update(total_weight=params2d.total_weight.shape[0],
              running_vis=params2d.running_vis.shape[0])
  assert all(v == n_target for v in rows.values()), rows
  for k, v in params2d.tensors.items():
    assert v.shape[0] == n_target and torch.isfinite(v).all(), k
  assert image2d.shape == (height, width, 3) and torch.isfinite(image2d).all()
  assert history[-1]["psnr"] > history[0]["psnr"], history
  print(f"  {params2d.num_points} points, every optimizer state row count "
        f"equal to it, finite parameters; PSNR {history[0]['psnr']:.3f} after "
        f"the first epoch, {history[-1]['psnr']:.3f} after the last")
  del params2d, image2d

  # ---- phase 8: the trained-scene path at full size ------------------------
  trained_scene(args, dev, card, kernels, camera, g_image)

  # ---- phase 9: the parallel path at full size -----------------------------
  parallel_paths(args, dev, card, kernels, scene, camera)

  # ---- phase 10: the feature-field frame at full size ----------------------
  # its kernels' launches, errors, times and bounds make the JSON line; no
  # PyTorch call computes the forward or the backward blend
  measured = feature_field(args, dev, card, kernels, scene, camera)

  # ---- phase 11: tile sizes that are not whole warps or exceed a block -----
  print(f"[11 tile sizes] phase 3's scene at tiles 12 and 40, RGB and F = 34")
  tile_sizes(args, dev, card, kernels, scene, camera)

  # ---- phase 12: the optimizer kernel --------------------------------------
  print("[12 optimizer] csrc/optim.cu against the plain passes on the card; "
        "the training cells' steps at 6.1M points")
  torch.cuda.empty_cache()
  optimizer_instances(dev)
  measured["optim_step"] = optimizer_widths(dev)
  print(card_line())
  print(json.dumps({"kernels": [
      {"name": name, "route": "cuda", "source": KERNELS[name][0],
       "replaces": KERNELS[name][1], "launches": launches, "max_abs_err": err,
       "ms": ms, "plain_ms": plain, "bound_ms": bound["ms"],
       "bound_by": bound["bound_by"], "library_ms": library}
      for name, (launches, err, ms, plain, bound, library) in measured.items()]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": device_name,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
