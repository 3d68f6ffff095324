#!/usr/bin/env python3
"""The port's `parallel/` across several cards, one process a card:

    torchrun --standalone --nproc-per-node=N tools/parallel_cards.py
        [--n N] [--size WIDTH HEIGHT] [--device cpu]

Every rank takes chip_smoke.py's phase-3 scene (bench.py's recipe, seed 0,
broadcast from rank 0), 1M gaussians @2048x1536 by default, and runs on
`make_mesh()` (NCCL on cuda:<LOCAL_RANK>; with --device cpu, gloo on the
CPU, which is how to rehearse it without cards):

1. `dp_train_step`, local_batch 2, RasterConfig(compute_visibility=True),
   VisibilityAwareAdam, each rank its own two cameras (phase 3's moved
   0.02 * k along x, k the camera's place in the global batch) and seeded
   targets: eight steps, ms/step; every rank's parameters equal to rank
   0's bit for bit. Rank 0 also times the same step on `make_mesh(1)`
   with its own two cameras. Then one step with the same two cameras on
   every rank and unit weights (RasterConfig(), FractionalAdam), on the
   world and on `make_mesh(1)`: how many parameters differ (equal
   summands averaged over the ranks are exact when the reduction adds
   them in pairs, not always otherwise).
2. `pp_project` against `project_to_image` (rtol 1e-6, in_view equal;
   whether bit for bit).
3. `tp_rasterize` on equal and on balanced stripes: the blocks gathered
   from all ranks and assembled, held against the full frame within rtol
   1e-4 / atol 2e-5, with the share of bit-equal pixels; every rank's ms
   beside the full frame's.
4. `tp_train_step` on equal stripes, local_points = N,
   RasterConfig(compute_point_heuristic=True): zero dropped, the loss
   within relative 1e-5 and the gradients, heuristics and visibility
   within 1e-3 of their largest |value| of the full-frame step; ms.

Times are host-clock ms, medians of 7 calls after a warm-up call; before
each timed call of a world the ranks meet at a barrier, so a collective's
time is not another rank's late start. The one-card references (the
world-1 step, project_to_image, the full frame's raster and training
step) are timed in the same run. Rank 0 prints the results, then one
JSON line. A failed check raises on its rank, so the launcher exits
non-zero.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 7


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--n", type=int, default=1_000_000)
  parser.add_argument("--size", type=int, nargs=2, default=(2048, 1536),
                      metavar=("WIDTH", "HEIGHT"))
  parser.add_argument("--device", default=None,
                      help="cpu for a gloo world on the CPU")
  args = parser.parse_args()
  sys.path.insert(0, ROOT)
  import chip_smoke
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  from taichi_gaussian_rasterizer_tpu_torch import parallel
  from taichi_gaussian_rasterizer_tpu_torch.ops import lib
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (backward,
                                                               forward, reduce)
  from taichi_gaussian_rasterizer_tpu_torch.optim import (
      FractionalAdam, ParameterClass, VisibilityAwareAdam)
  from taichi_gaussian_rasterizer_tpu_torch.utils.cuda_build import load_all

  mesh = parallel.make_mesh(device=args.device)
  dev, rank, d = mesh.device, mesh.rank, mesh.size
  cuda = dev.type == "cuda"

  def sync():
    if cuda:
      torch.cuda.synchronize(dev)

  def timed(fn, group=None):
    """fn's result and its ms on the host clock; with a group, its ranks
    start together (a barrier first), so a collective's time is not
    another rank's late arrival."""
    if group is not None:
      dist.barrier(group=group, device_ids=[dev.index] if cuda else None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3

  def host_ms(fn, reps=REPS, group=None):
    """Median ms of reps calls after one warm-up call."""
    fn()
    return statistics.median(timed(fn, group)[1] for _ in range(reps))

  def every_rank(value: float):
    """value from every rank, on every rank."""
    parts = [torch.zeros(1, dtype=torch.float64, device=dev) for _ in range(d)]
    dist.all_gather(parts, torch.tensor([value], dtype=torch.float64,
                                        device=dev), group=mesh.group)
    return [float(p) for p in parts]

  def say(msg):
    if rank == 0:
      print(msg, flush=True)

  result = {"world": d, "device": str(dev)}
  try:
    if cuda:
      load_all([forward.RASTER_FORWARD, backward.RASTER_BACKWARD,
                reduce.SEGMENT_SUM])
      result["card"] = chip_smoke.card_line()
    width, height = args.size
    size = (width, height)
    scene, camera = parallel.replicate(chip_smoke.bench_scene(args.n, size, dev),
                                       mesh)
    n = scene.position.shape[0]
    near, far = camera.near_plane, camera.far_plane
    keys = [f.name for f in dataclasses.fields(tgr.Gaussians3D)]
    say(f"[parallel] a world of {d} ranks, {dist.get_backend()} on {dev}; "
        f"{n} gaussians @{width}x{height}; {result.get('card', 'cpu')}")

    # ---- 1. dp_train_step ------------------------------------------------
    def fresh(optimizer):
      return ParameterClass.create(
          {k: getattr(scene, k).detach().clone() for k in keys},
          {k: dict(lr=1e-3) for k in keys}, optimizer)

    shifts = torch.arange(2 * d, dtype=torch.float32, device=dev) * 0.02
    t_cams = camera.T_camera_world.expand(2 * d, 4, 4).clone()
    t_cams[:, 0, 3] += shifts
    projections = camera.projection.expand(2 * d, 4).contiguous()
    targets = torch.rand((2 * d, height, width, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    vis_config = tgr.RasterConfig(compute_visibility=True)
    own = parallel.shard_leading((projections, t_cams, targets), mesh)
    step = parallel.dp_train_step(mesh, vis_config, size, local_batch=2,
                                  depth_range=(near, far))
    params = parallel.replicate(fresh(VisibilityAwareAdam), mesh)
    times, losses = [], []
    for _ in range(1 + REPS):
      (params, loss), ms = timed(lambda: step(params, *own), mesh.group)
      times.append(ms)
      losses.append(float(loss))
    for k in keys:
      assert torch.equal(parallel.replicate(params.tensors[k], mesh),
                         params.tensors[k]), f"rank {rank}: replica {k} differs"
    result.update(dp_ms=times, dp_median_ms=statistics.median(times[1:]),
                  dp_losses=losses)
    say(f"  dp_train_step, local_batch 2 ({2 * d} cameras a step), "
        f"visibility, VisibilityAwareAdam: ms/step "
        f"{', '.join(f'{t:.3f}' for t in times)} (median after the first "
        f"{statistics.median(times[1:]):.3f}); losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; every rank's parameters "
        f"equal to rank 0's bit for bit")

    same = (projections[:2], t_cams[:2], targets[:2])
    plain = parallel.dp_train_step(mesh, tgr.RasterConfig(), size,
                                   local_batch=2, depth_range=(near, far))
    world_params, _ = plain(parallel.replicate(fresh(FractionalAdam), mesh),
                            *same)
    mesh1 = parallel.make_mesh(1, device=args.device)
    if mesh1 is not None:
      step1 = parallel.dp_train_step(mesh1, vis_config, size, local_batch=2,
                                     depth_range=(near, far))
      params1 = fresh(VisibilityAwareAdam)
      times1 = [timed(lambda: step1(params1, *own))[1]
                for _ in range(1 + REPS)]
      one, _ = parallel.dp_train_step(mesh1, tgr.RasterConfig(), size,
                                      local_batch=2, depth_range=(near, far))(
                                          fresh(FractionalAdam), *same)
      differ = {k: int((world_params.tensors[k] != one.tensors[k]).sum())
                for k in keys}
      result.update(dp_ms_world1=times1,
                    dp_median_ms_world1=statistics.median(times1[1:]),
                    dp_unit_weight_differ=differ)
      print(f"  the same step on make_mesh(1), 2 cameras: ms/step "
            f"{', '.join(f'{t:.3f}' for t in times1)} (median after the first "
            f"{statistics.median(times1[1:]):.3f}); identical cameras with "
            f"unit weights, world {d} against world 1: parameters that differ "
            f"{differ}", flush=True)
    del params, world_params, own, targets

    # ---- 2. pp_project ---------------------------------------------------
    config = tgr.RasterConfig()
    project = parallel.pp_project(mesh, config, size, (near, far))
    with torch.no_grad():
      got = project(scene, camera.projection, camera.T_camera_world)
      want = tgr.project_to_image(scene, camera, config)
      assert torch.equal(got[2], want[2]), f"rank {rank}: in_view differs"
      for a, b in zip(got[:2], want[:2]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-5), float((a - b).abs().max())
      bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
      pp_ms = host_ms(lambda: project(scene, camera.projection,
                                      camera.T_camera_world), group=mesh.group)
      proj_ms = host_ms(lambda: tgr.project_to_image(scene, camera, config))
    result.update(pp_bitwise=bitwise, pp_ms=pp_ms, project_ms=proj_ms)
    say(f"  pp_project against project_to_image: bit for bit {bitwise}; "
        f"{pp_ms:.3f} ms against {proj_ms:.3f} ms (rank 0)")

    # ---- 3. tp_rasterize -------------------------------------------------
    ts = config.tile_size
    features = scene.feature
    with torch.no_grad():
      points, depths, _ = tgr.project_to_image(scene, camera, config)
      depth = lib.ndc_depth(torch.clamp(depths, min=near), near, far)[:, 0]
      assert not bool(tgr.map_to_tiles(points, depth, size, config).overflow)
      full = tgr.rasterize(points, depth, features, size, config)
      full_ms = host_ms(lambda: tgr.rasterize(points, depth, features, size,
                                              config))
      loads = parallel.stripe_row_loads(points, depth, size, config)
      partitions = {"equal": (height // (d * ts),) * d,
                    "balanced": parallel.balance_stripe_rows(loads, d)}
      for label, rows in partitions.items():
        tp = parallel.tp_rasterize(mesh, config, size, stripe_rows=rows)
        image, weight, _ = tp(points, depth, features)
        ms = every_rank(host_ms(lambda: tp(points, depth, features),
                                group=mesh.group))
        block = torch.cat([image, weight[..., None]], -1).contiguous()
        parts = [torch.empty_like(block) for _ in range(d)]
        dist.all_gather(parts, block, group=mesh.group)
        got = parallel.assemble_stripes(torch.cat(parts), rows, ts)
        want = torch.cat([full.image, full.image_weight[..., None]], -1)
        assert torch.allclose(got, want, rtol=1e-4, atol=2e-5), label
        share = float((got == want).all(-1).double().mean())
        mx = float((got - want).abs().max())
        result[f"tp_{label}"] = dict(rows=list(rows), ms=ms, bit_equal=share,
                                     max_abs_diff=mx)
        stripe_loads, start = [], 0
        for r in rows:
          stripe_loads.append(int(loads[start:start + r].sum()))
          start += r
        say(f"  tp_rasterize, {label} stripes {list(rows)} tile rows, loads "
            f"{stripe_loads}: ms per rank {', '.join(f'{t:.3f}' for t in ms)} "
            f"against the full frame's raster {full_ms:.3f} ms; max |diff| "
            f"{mx:.3e}, {share:.6f} of pixels bit-equal")
      result["full_frame_raster_ms"] = full_ms

    # ---- 4. tp_train_step ------------------------------------------------
    config = tgr.RasterConfig(compute_point_heuristic=True)
    target = torch.rand((height, width, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(8))
    train = parallel.tp_train_step(mesh, config, size, local_points=n)
    loss, grads, heur, vis, dropped = train(points, depth, features, target)
    ms = every_rank(host_ms(lambda: train(points, depth, features, target),
                            group=mesh.group))

    def full_step():
      leaves = [points.detach().requires_grad_(),
                features.detach().requires_grad_(),
                points.new_zeros(n, 2, requires_grad=True),
                points.new_zeros(n, requires_grad=True)]
      out = tgr.rasterize(leaves[0], depth, leaves[1], size, config,
                          heuristic_sink=leaves[2], visibility_sink=leaves[3])
      full_loss = torch.sum((out.image - target) ** 2)
      return full_loss.detach(), torch.autograd.grad(full_loss, leaves)

    full_loss, want = full_step()
    full_train_ms = host_ms(full_step)
    assert int(dropped) == 0, int(dropped)
    loss_rel = abs(float(loss) / float(full_loss) - 1)
    assert loss_rel <= 1e-5, loss_rel
    rels = {}
    for name, g, w in zip(("grad_points", "grad_features", "heuristics",
                           "visibility"), (*grads, heur, vis), want):
      rels[name] = float((g - w).abs().max() / w.abs().max())
      assert rels[name] <= 1e-3, (name, rels[name])
    result["tp_train"] = dict(ms=ms, full_frame_ms=full_train_ms,
                              loss_rel=loss_rel, rel=rels)
    say(f"  tp_train_step, local_points {n}: 0 dropped; loss relative diff "
        f"{loss_rel:.3e}; max |diff| / max |full| "
        f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())}; ms per rank "
        f"{', '.join(f'{t:.3f}' for t in ms)} against the full frame's "
        f"{full_train_ms:.3f} ms on one card")
  finally:
    dist.destroy_process_group()
  say(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
