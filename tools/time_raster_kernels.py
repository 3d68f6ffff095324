#!/usr/bin/env python3
"""Time the port's raster kernels on one NVIDIA GPU at chip_smoke.py's
frames, for the checkout of the port under --root, so that two versions
of the kernels can be held side by side in one call on one card (run them
in turns: parent, change, change, parent).

Frames, at 1M gaussians @2048x1536, with tiles of --tile-size pixels
(default 16, RasterConfig()'s):
* 3D: chip_smoke.py phases 3 and 5 (bench.py's recipe, RGB): the forward
  kernel without and with visibility, the backward kernel with 9 rows
  (cotangent image seeded normal, zero weight cotangent), the segment sum
  of 9 seeded rows and the gradient reduction (`reduce_slots_by_point`:
  the sort and the per-point sums) of the backward's 9 rows; the forward
  and the backward (10 rows) under the antialiased pdf (bench.py's
  antialias row); the forward and the backward of phase 10's feature
  field, 32 seeded raw channels and the two depth channels (F = 34), and
  of 17, 64 and 128 seeded raw channels (the wide instances), and the
  reduction of the backward's 134 rows at F = 128;
* 2D: 1M random_2d_gaussians (seed 0) on the 2D trainer's frame
  (compute_point_heuristic, F = 3): the forward kernel and the backward
  kernel with the heuristic and visibility rows (12);
* with --phase2, chip_smoke.py phase 2's saturating frame instead: the
  forward in its four modes without and with visibility, the backward
  conic and antialiased.
A call that the checkout's kernels refuse (a tile size or a width an
older checkout does not take) is listed under "refused" with its error.

Each time is the mean of 20 launches after two warm-up launches, by CUDA
events. --work counts each frame's (pixel, slot) work and adds each
kernel's bound (ops/raster/bounds.py, which the checkout must have);
--profile adds torch.profiler's device time of one launch of each
kernel. --ablate NAME ... also times builds of the checkout's kernels with
one part cut out by a text substitution at the text's first occurrence
(the F <= 16 kernels', where the wide ones repeat the text; ABLATIONS;
the result is wrong, the change in time is that part's cost), each built
by nvcc into a scratch directory; a substitution whose text the checkout
lacks is an error. One JSON line goes to stdout and, with --out, is
appended to that file.

    python3 tools/time_raster_kernels.py [--root DIR] [--out FILE] [--work]
        [--profile] [--phase2] [--tile-size N] [--ablate NAME ...]
"""

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile

import torch

N, SIZE, REPS = 1_000_000, (2048, 1536), 20
WIDE_FEATURES = (17, 34, 64, 128)

# name: (file under csrc/, text cut, replacement); an ablation rebuilds
# every raster kernel its file reaches and times that kernel's calls
ABLATIONS = {
    # the one-pixel-a-thread backward kernel: per-row warp shuffles, the
    # whole slot loop
    "one_pixel_row_shuffles": ("raster_backward.cu",
                               "const float x = warp_sum(v[r]);",
                               "const float x = v[r];"),
    "one_pixel_slot_loop": (
        "raster_backward.cu",
        "for (int sub = 0; sub < count && alive; sub += kSub) {",
        "for (int sub = 0; sub < 0; sub += kSub) {"),
    # several pixels a thread: the transposed reduction, the slot loops,
    # the threshold box (cut: every pair evaluated)
    "transposed_sums": ("raster_backward.cu",
                        "const float x = transpose_reduce<kRows>(v, lane);",
                        "const float x = v[0];"),
    "backward_slot_loop": ("raster_backward.cu",
                           "for (int j = 0; j < count; ++j) {",
                           "for (int j = 0; j < 0; ++j) {"),
    "forward_slot_masks": (
        "raster_forward.cu",
        "for (int c0 = 0; c0 < count && done != kAllDone; c0 += 32) {",
        "for (int c0 = 0; c0 < 0; c0 += 32) {"),
    "threshold_box": ("raster_common.cuh",
                      "return fabsf(cx - m.x) > e.x || ry > e.y;",
                      "return false;"),
    # the wide (F > 16) kernels: the forward's image product, its replay
    # (the slot loop blends nothing, so no pixel stops), the backward's D
    # product, its replay and its feature-row product
    "wide_forward_product": (
        "raster_forward.cu",
        "unsigned todo = __reduce_or_sync(kFullMask, wmask);",
        "unsigned todo = 0u * wmask;"),
    "wide_forward_replay": ("raster_forward.cu",
                            "blend_slot(__ffs(todo) - 1);", "(void)0;"),
    "wide_backward_d": (
        "raster_backward.cu",
        "for (unsigned todo = need; todo != 0; todo &= todo - 1) {",
        "for (unsigned todo = 0; todo != 0; todo &= todo - 1) {"),
    "wide_backward_replay": (
        "raster_backward.cu",
        "for (int j = 0; j < count; ++j) {\n          float* xj",
        "for (int j = 0; j < 0; ++j) {\n          float* xj"),
    "wide_backward_feature_rows": (
        "raster_backward.cu",
        "for (int c0 = 4 * quads * warp; c0 < nf; c0 += 4 * quads * n_warps) {",
        "for (int c0 = nf; c0 < nf; c0 += 4 * quads * n_warps) {"),
}


def main() -> int:
  here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--root", default=here,
                      help="directory holding taichi_gaussian_rasterizer_tpu_torch")
  parser.add_argument("--out", default=None)
  parser.add_argument("--work", action="store_true")
  parser.add_argument("--profile", action="store_true")
  parser.add_argument("--phase2", action="store_true")
  parser.add_argument("--tile-size", type=int, default=16,
                      help="tile size of the 3D and 2D frames")
  parser.add_argument("--ablate", nargs="+", default=(), choices=sorted(ABLATIONS))
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("time_raster_kernels: no CUDA device", file=sys.stderr)
    return 1
  root = os.path.abspath(args.root)
  # the package from --root, chip_smoke.py's frames from this checkout
  sys.path[:0] = [root, here]

  import chip_smoke
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch.models import renderer2d
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
      backward, forward, reduce, reduce_slots_by_point)
  from taichi_gaussian_rasterizer_tpu_torch.utils import cuda_build
  from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import (
      random_2d_gaussians)
  assert os.path.dirname(os.path.dirname(tgr.__file__)) == root

  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device("cuda")
  kernels = {"raster_forward.cu": forward.RASTER_FORWARD,
             "raster_backward.cu": backward.RASTER_BACKWARD}
  call_prefix = {"raster_forward.cu": "forward_", "raster_backward.cu": "backward_"}
  cuda_build.load_all([*kernels.values(), reduce.SEGMENT_SUM])
  if hasattr(reduce, "POINT_SUMS"):   # the one-pass reduction: the same library
    reduce.POINT_SUMS.load()
  result = {"root": root, "card": chip_smoke.card_line(), "ms": {},
            "tile_size": args.tile_size,
            "ptxas": {k.source: [l.strip() for l in k.build_log.splitlines()
                                 if "entry function" in l or "registers" in l
                                 or "spill" in l]
                      for k in kernels.values()}}
  ms = result["ms"]

  with torch.no_grad():
    if args.phase2:
      fr = chip_smoke.saturating_frame(dev)
      calls = {}
      for antialias in (False, True):
        for blending in (True, False):
          cfg = fr.config.replace(antialias=antialias, use_alpha_blending=blending)
          mode = (f"{'blending' if blending else 'quantile'}_"
                  f"{'antialias' if antialias else 'conic'}")
          for vis in (False, True):
            calls[f"forward_{mode}{'_visibility' if vis else ''}"] = (
                lambda cfg=cfg, vis=vis: forward.rasterize_forward(
                    fr.points, fr.features, fr.mapping, fr.size, cfg,
                    compute_visibility=vis))
          if blending:
            image, weight = forward.rasterize_forward(
                fr.points, fr.features, fr.mapping, fr.size, cfg)
            bw = (fr.points, fr.features, fr.mapping, cfg, image, weight,
                  fr.g_image, fr.g_weight)
            calls[f"backward_{mode}"] = (
                lambda bw=bw: backward.rasterize_backward(*bw))
    else:
      # the 3D frame
      scene, camera = chip_smoke.bench_scene(N, SIZE, dev)
      config = tgr.RasterConfig(tile_size=args.tile_size)
      points, mapping = chip_smoke.project_and_map(scene, camera, config)
      features = scene.feature.contiguous()
      g_image = torch.randn((SIZE[1], SIZE[0], 3), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
      image, weight = forward.rasterize_forward(points, features, mapping, SIZE,
                                                config)
      bw = (points, features, mapping, config, image, weight, g_image,
            torch.zeros_like(weight))
      # the segment sum's input: 9 seeded rows over the frame's slots,
      # grouped by point (its time does not depend on the values)
      grouped = torch.randn(
          (9, mapping.overlap_to_point.shape[0]), device=dev,
          generator=torch.Generator(device=dev).manual_seed(3)).index_select(
              1, torch.sort(mapping.overlap_to_point, stable=True)[1])
      config_aa = config.replace(antialias=True)
      image_aa, weight_aa = forward.rasterize_forward(points, features, mapping,
                                                      SIZE, config_aa)
      bw_aa = (points, features, mapping, config_aa, image_aa, weight_aa,
               g_image, torch.zeros_like(weight_aa))
      # phase 10's feature field: depth, depth^2 and 32 raw channels (F =
      # 34), and F = 17, 64, 128 seeded raw channels
      _, depths, _ = tgr.project_to_image(scene, camera, config)
      gen_f = torch.Generator(device=dev).manual_seed(10)
      wide = {}
      for f in WIDE_FEATURES:
        raw = torch.rand((N, 32 if f == 34 else f), device=dev, generator=gen_f)
        feats = torch.cat([depths, depths * depths, raw], 1) if f == 34 else raw
        image_f, weight_f = forward.rasterize_forward(points, feats, mapping,
                                                      SIZE, config)
        g_image_f = torch.randn((SIZE[1], SIZE[0], f), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(11))
        wide[f] = (feats, (points, feats, mapping, config, image_f, weight_f,
                           g_image_f, torch.zeros_like(weight_f)))

      # the 2D trainer's frame
      g2 = random_2d_gaussians(torch.Generator(device=dev).manual_seed(0), N, SIZE)
      config2 = tgr.RasterConfig(tile_size=args.tile_size,
                                 compute_point_heuristic=True)
      packed = renderer2d.project_gaussians2d(g2).contiguous()
      mapping2 = tgr.map_to_tiles(
          packed, torch.clamp(g2.z_depth.reshape(-1), 0.0, 1.0), SIZE, config2)
      f2 = g2.feature.contiguous()
      image2, weight2 = forward.rasterize_forward(packed, f2, mapping2, SIZE,
                                                  config2)
      g_image2 = torch.randn((SIZE[1], SIZE[0], 3), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(4))
      bw2 = (packed, f2, mapping2, config2, image2, weight2, g_image2,
             torch.zeros_like(weight2), True, True)

      slots = backward.rasterize_backward(*bw)
      slots_128 = backward.rasterize_backward(*wide[128][1])
      calls = {
          "forward_3d": lambda: forward.rasterize_forward(
              points, features, mapping, SIZE, config),
          "forward_3d_visibility": lambda: forward.rasterize_forward(
              points, features, mapping, SIZE, config, compute_visibility=True),
          "backward_3d_9_rows": lambda: backward.rasterize_backward(*bw),
          "segment_sum_3d": lambda: reduce.segment_sums_cuda(
              grouped, mapping.point_offsets, N),
          "reduce_3d_9_rows": lambda: reduce_slots_by_point(slots, mapping),
          "reduce_3d_128": lambda: reduce_slots_by_point(slots_128, mapping),
          "forward_3d_antialias": lambda: forward.rasterize_forward(
              points, features, mapping, SIZE, config_aa),
          "backward_3d_antialias": lambda: backward.rasterize_backward(*bw_aa),
          "forward_2d": lambda: forward.rasterize_forward(packed, f2, mapping2,
                                                          SIZE, config2),
          "backward_2d_12_rows": lambda: backward.rasterize_backward(*bw2),
      }
      for f, (feats, bw_f) in wide.items():
        calls[f"forward_3d_{f}"] = (
            lambda feats=feats: forward.rasterize_forward(points, feats, mapping,
                                                          SIZE, config))
        calls[f"backward_3d_{f}"] = (
            lambda bw_f=bw_f: backward.rasterize_backward(*bw_f))
      result["slots"] = {"3d": int(mapping.total_overlaps),
                         "2d": int(mapping2.total_overlaps)}

    # a checkout whose kernels refuse a call (a tile size or a width) lists
    # it under "refused"
    for name, fn in list(calls.items()):
      try:
        fn()
      except (ValueError, RuntimeError) as e:
        result.setdefault("refused", {})[name] = str(e)[:120]
        del calls[name]
    for name, fn in calls.items():
      ms[name] = chip_smoke.cuda_ms(fn, REPS, warmup=2)

    if args.profile:
      from torch.profiler import ProfilerActivity, profile
      result["profile_ms"] = {}
      for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
          fn()
          torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        result["profile_ms"][name] = {
            e.key[:60]: e.device_time_total / 1e3 for e in events}

    if args.work and not args.phase2:
      from taichi_gaussian_rasterizer_tpu_torch.ops.raster import bounds
      tiles_n = mapping.tile_ranges.shape[0]
      # warp counts only where the tile is whole warps of 4 pixels a thread
      layouts = (1, 4) if (args.tile_size ** 2) % 128 == 0 else ()
      w3 = bounds.raster_work(points, mapping, config, SIZE, layouts=layouts)
      w3a = bounds.raster_work(points, mapping, config_aa, SIZE, layouts=layouts)
      w2 = bounds.raster_work(packed, mapping2, config2, SIZE, layouts=layouts)
      k3, k2 = int(mapping.total_overlaps), int(mapping2.total_overlaps)
      result["work"] = {"3d": w3, "3d_antialias": w3a, "2d": w2}
      result["bounds"] = {
          "forward_3d": bounds.forward_bound(w3, N, 3, k3, tiles_n, SIZE, False),
          "forward_3d_visibility": bounds.forward_bound(
              w3, N, 3, k3, tiles_n, SIZE, False, visibility=True),
          "backward_3d_9_rows": bounds.backward_bound(
              w3, N, 3, k3, tiles_n, SIZE, False, False, False),
          "segment_sum_3d": bounds.segment_sum_bound(9, k3, N),
          "reduce_3d_9_rows": bounds.segment_sum_bound(9, k3, N),
          "reduce_3d_128": bounds.segment_sum_bound(134, k3, N),
          "forward_3d_antialias": bounds.forward_bound(
              w3a, N, 3, k3, tiles_n, SIZE, True),
          "backward_3d_antialias": bounds.backward_bound(
              w3a, N, 3, k3, tiles_n, SIZE, True, False, False),
          "forward_2d": bounds.forward_bound(w2, N, 3, k2, tiles_n, SIZE, False),
          "backward_2d_12_rows": bounds.backward_bound(
              w2, N, 3, k2, tiles_n, SIZE, False, True, True),
      }
      for f in WIDE_FEATURES:
        result["bounds"].update({
            f"forward_3d_{f}": bounds.forward_bound(w3, N, f, k3, tiles_n, SIZE,
                                                    False),
            f"backward_3d_{f}": bounds.backward_bound(w3, N, f, k3, tiles_n,
                                                      SIZE, False, False, False)})
      for name, b in result["bounds"].items():
        if name in ms:
          b["share"] = b["ms"] / ms[name]

    if args.ablate:
      csrc, build_dir = cuda_build.CSRC_DIR, cuda_build.BUILD_DIR
      result["ablated_ms"] = {}
      for name in args.ablate:
        source, old, new = ABLATIONS[name]
        text = (csrc / source).read_text()
        if old not in text:
          raise SystemExit(f"ablation {name}: {source} under {root} does not "
                           f"hold its text")
        # a header reaches both raster kernels
        touched = {s: k for s, k in kernels.items()
                   if source.endswith(".cuh") or s == source}
        with tempfile.TemporaryDirectory() as tmp:
          tmp = pathlib.Path(tmp)
          shutil.copytree(csrc, tmp / "csrc")
          (tmp / "csrc" / source).write_text(text.replace(old, new, 1))
          intact = {s: k._fn for s, k in touched.items()}
          cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = tmp / "csrc", tmp / "build"
          try:
            for k in touched.values():
              k._fn = None
            cuda_build.load_all(list(touched.values()))
            prefixes = tuple(call_prefix[s] for s in touched)
            result["ablated_ms"][name] = {c: chip_smoke.cuda_ms(fn, REPS, warmup=2)
                                          for c, fn in calls.items()
                                          if c.startswith(prefixes)}
          finally:
            cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = csrc, build_dir
            for s, k in touched.items():
              k._fn = intact[s]

  line = json.dumps(result)
  print(line)
  if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
      f.write(line + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
