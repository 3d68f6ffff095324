"""The ranks of the port's multi-rank tests (tests/test_torch_parallel.py).

Imports torch and the port, never JAX: each rank is a spawned process that
imports this module (and not the test module, which imports JAX). The
scenes are numpy arrays made from seeds by the functions below, so the
test rebuilds the same inputs for the single-process port and the JAX
package.

`World(world_size, out_dir, cases=None)` spawns the ranks of one gloo
world with its own `file://` rendezvous under out_dir. Each rank runs
every case of CASES (or the named ones) on the whole world (and the runs on worlds of 2 and 1 on
`make_mesh(2)` and `make_mesh(1)`) and writes its results, numpy arrays named `<case>.<name>`, to
out_dir/rank<r>.npz. `World.results()` waits for the ranks, with a time
limit, and loads those files.
"""

import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from taichi_gaussian_rasterizer_tpu_torch import Gaussians3D, RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.optim import (
    FractionalAdam, ParameterClass, VisibilityAwareAdam)
from taichi_gaussian_rasterizer_tpu_torch.parallel import (
    balance_stripe_rows, dp_train_step, make_mesh, pp_project, replicate,
    shard_leading, stripe_row_loads, tp_rasterize, tp_train_step)

import torch_port_scenes as scenes

WORLD = 4
KEYS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")

# ---- the scenes (numpy, float64) ---------------------------------------------

DP_SIZE, DP_N, DP_DEPTH_RANGE = (48, 32), 48, (0.1, 100.0)
TP_SIZE, TP_N = (64, 128), 120          # 4 stripes of two 16-pixel tile rows
SKEW_SIZE, SKEW_N = (64, 256), 160      # 16 tile rows over 4 stripes


def dp_config(**kw):
  return RasterConfig(tile_size=16, points_per_chunk=8,
                      compute_visibility=True, **kw)


def tp_config(**kw):
  return RasterConfig(tile_size=16, points_per_chunk=8, **kw)


def dp_scene(distinct: bool):
  """Gaussians (numpy dict), WORLD cameras (projections (D, 4), T (D, 4, 4))
  and targets (D, H, W, 3): one camera and target repeated, or each
  camera moved and each target drawn anew."""
  cam = scenes.camera(0, DP_SIZE)
  g = scenes.gaussians3d(1, DP_N, cam)
  rng = np.random.default_rng(2 if distinct else 3)
  proj = np.tile(cam["projection"], (WORLD, 1))
  t_cam = np.tile(cam["T_camera_world"], (WORLD, 1, 1))
  w, h = DP_SIZE
  if distinct:
    t_cam[:, :3, 3] += rng.normal(size=(WORLD, 3)) * 0.1
    targets = rng.uniform(size=(WORLD, h, w, 3))
  else:
    targets = np.tile(rng.uniform(size=(1, h, w, 3)), (WORLD, 1, 1, 1))
  return g, proj, t_cam, targets


def pp_scene():
  """63 gaussians (not a multiple of WORLD), some out of view, a camera
  and the seeded cotangents of the projected points and depths."""
  cam = scenes.camera(30, (64, 48))
  g = scenes.gaussians3d(31, 63, cam, margin=0.5)
  rng = np.random.default_rng(32)
  return g, cam, rng.normal(size=(63, 7)), rng.normal(size=(63, 1))


def tp_scene(seed: int, n: int = TP_N, size=TP_SIZE):
  """Packed 2D gaussians, depths, features and a seeded image-sized
  array (the cotangent or the target)."""
  points, depth, feats = scenes.points2d(seed, n, size)
  rng = np.random.default_rng(seed + 100)
  return points, depth, feats, rng.uniform(size=(size[1], size[0], 3))


def skew_scene():
  """tp_scene at 64x256 with 90% of the gaussians squeezed into the top
  two tile rows: the overlaps crowd a few rows."""
  points, depth, feats, target = tp_scene(42, SKEW_N, SKEW_SIZE)
  points = points.copy()
  crowd = np.arange(SKEW_N) < int(0.9 * SKEW_N)
  points[crowd, 1] *= 30.0 / SKEW_SIZE[1]
  return points, depth, feats, target - 0.5


def param_groups():
  return {k: dict(lr=0.01) for k in KEYS}


# ---- the cases: each runs on every rank, returns numpy arrays -----------------


def t(x):
  return torch.as_tensor(np.asarray(x))


def to_np(x):
  return x.detach().cpu().numpy()


def case_dp(meshes):
  """dp_train_step, the parameters and loss after one step: identical
  cameras with visibility and VisibilityAwareAdam on the whole world and
  on a world of 1; distinct cameras; identical cameras without visibility
  (FractionalAdam with unit weights) on worlds of WORLD, 2 and 1."""
  out = {}
  runs = [("same", False, WORLD, dp_config(), VisibilityAwareAdam),
          ("same1", False, 1, dp_config(), VisibilityAwareAdam),
          ("distinct", True, WORLD, dp_config(), VisibilityAwareAdam)]
  runs += [(f"plain{n}", False, n, tp_config(), FractionalAdam)
           for n in (WORLD, 2, 1)]
  for label, distinct, size, config, optimizer in runs:
    mesh = meshes[size]
    if mesh is None:
      continue
    g, proj, t_cam, targets = dp_scene(distinct)
    params = ParameterClass.create({k: t(v) for k, v in g.items()},
                                   param_groups(), optimizer)
    step = dp_train_step(mesh, config, DP_SIZE, depth_range=DP_DEPTH_RANGE)
    params, loss = step(replicate(params, mesh), *shard_leading(
        (t(proj[:size]), t(t_cam[:size]), t(targets[:size])), mesh))
    out[f"{label}.loss"] = to_np(loss)
    out.update({f"{label}.{k}": to_np(v) for k, v in params.tensors.items()})
    out[f"{label}.running_vis"] = to_np(params.running_vis)
  return out


def case_pp(meshes):
  mesh = meshes[WORLD]
  """pp_project: values, and the gradient of vdot(points, Gp) + vdot(depth,
  Gd) (the same loss on every rank) on the four shape tensors."""
  g, cam, gp, gd = pp_scene()
  leaves = {k: t(v).requires_grad_() for k, v in g.items()}
  project = pp_project(mesh, dp_config(), cam["image_size"],
                       (cam["near"], cam["far"]))
  pts, depth, in_view = project(Gaussians3D(**leaves), t(cam["projection"]),
                                t(cam["T_camera_world"]))
  ((pts * t(gp)).sum() + (depth * t(gd)).sum()).backward()
  out = dict(points=to_np(pts), depth=to_np(depth), in_view=to_np(in_view))
  out.update({f"grad.{k}": to_np(leaves[k].grad) for k in KEYS[:4]})
  return out


def case_tp_rasterize(meshes):
  mesh = meshes[WORLD]
  """tp_rasterize with visibility: this rank's blocks, the all-reduced
  visibility, and the gradients of the stripe's share of vdot(image, G)."""
  points, depth, feats, cot = tp_scene(40)
  pts, f = t(points).requires_grad_(), t(feats).requires_grad_()
  tp = tp_rasterize(mesh, tp_config(compute_visibility=True), TP_SIZE)
  image, weight, vis = tp(pts, t(depth), f)
  h = image.shape[0]
  (image * t(cot)[mesh.rank * h:(mesh.rank + 1) * h]).sum().backward()
  return dict(image=to_np(image), weight=to_np(weight), vis=to_np(vis),
              grad_points=to_np(pts.grad), grad_features=to_np(f.grad))


def _train_out(result):
  loss, (gp, gf), heur, vis, overflow = result
  out = dict(loss=to_np(loss), grad_points=to_np(gp), grad_features=to_np(gf),
             overflow=to_np(overflow))
  if heur is not None:
    out["heuristics"] = to_np(heur)
  if vis is not None:
    out["vis"] = to_np(vis)
  return out


def case_tp_train(meshes):
  mesh = meshes[WORLD]
  """tp_train_step with local_points < N (training mode: heuristics and
  visibility), and with local_points too small (the overflow count)."""
  points, depth, feats, target = tp_scene(41)
  args = (t(points), t(depth), t(feats), t(target))
  step = tp_train_step(mesh, tp_config(compute_point_heuristic=True), TP_SIZE,
                       local_points=64)
  out = _train_out(step(*args))
  small = tp_train_step(mesh, tp_config(), TP_SIZE, local_points=8)
  out["small_overflow"] = _train_out(small(*args))["overflow"]
  return out


def case_skew(meshes):
  mesh = meshes[WORLD]
  """Balanced stripes on the skewed scene: the probed row loads, the
  partition, tp_rasterize's blocks and tp_train_step's results."""
  points, depth, feats, target = skew_scene()
  config = tp_config()
  loads = stripe_row_loads(t(points), t(depth), SKEW_SIZE, config)
  rows = balance_stripe_rows(loads, mesh.size)
  tp = tp_rasterize(mesh, config, SKEW_SIZE, stripe_rows=rows)
  image, weight, vis = tp(t(points), t(depth), t(feats))
  assert vis is None
  step = tp_train_step(mesh, config, SKEW_SIZE, local_points=SKEW_N,
                       stripe_rows=rows)
  out = _train_out(step(t(points), t(depth), t(feats), t(target)))
  out.update(loads=loads, rows=np.asarray(rows), image=to_np(image),
             weight=to_np(weight))
  return out


def case_refusals(meshes):
  """make_mesh refuses more ranks than the world has, and a CUDA mesh
  here (no card, or a gloo group where NCCL is needed)."""
  out = {}
  for label, kw in (("too_many", dict(n_devices=WORLD + 1, device="cpu")),
                    ("cuda", dict(device="cuda"))):
    try:
      make_mesh(**kw)
      out[label] = np.array(False)
    except (ValueError, RuntimeError):
      out[label] = np.array(True)
  return out


def case_spans(meshes):
  """One dp_train_step on a world of 2 under torch.profiler: the names of
  the port's span records (utils.tracing) on this rank, and for each the
  index of its parent record (-1 for none)."""
  from taichi_gaussian_rasterizer_tpu_torch.utils import tracing
  mesh = meshes[2]
  if mesh is None:
    return {}
  g, proj, t_cam, targets = dp_scene(False)
  params = ParameterClass.create({k: t(v) for k, v in g.items()},
                                 param_groups(), FractionalAdam)
  step = dp_train_step(mesh, tp_config(), DP_SIZE, depth_range=DP_DEPTH_RANGE)
  tracing.clear()
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    step(params, *shard_leading((t(proj[:2]), t(t_cam[:2]), t(targets[:2])), mesh))
  recs = tracing.records()
  index = {r["id"]: i for i, r in enumerate(recs)}
  return dict(names=np.array([r["name"] for r in recs]),
              parents=np.array([index.get(r["parent"], -1) for r in recs]))


CASES = {"refusals": case_refusals, "dp": case_dp, "pp": case_pp, "tp_rasterize": case_tp_rasterize,
         "tp_train": case_tp_train, "skew": case_skew, "spans": case_spans}


# ---- the world -----------------------------------------------------------------


def rank_main(rank: int, world_size: int, out_dir: str, cases=None):
  torch.set_num_threads(1)
  dist.init_process_group(
      "gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
      world_size=world_size, timeout=datetime.timedelta(seconds=60))
  try:
    meshes = {n: make_mesh(n, device="cpu") for n in (world_size, 2, 1)}
    results = {}
    for name in cases or CASES:
      case = CASES[name]
      results.update({f"{name}.{k}": v for k, v in case(meshes).items()})
    np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
  except BaseException:
    traceback.print_exc()
    raise
  finally:
    dist.destroy_process_group()


class World:
  """The processes of one spawned gloo world."""

  def __init__(self, world_size: int, out_dir: Path, cases=None):
    self.out_dir = Path(out_dir)
    ctx = multiprocessing.get_context("spawn")
    self.procs = [ctx.Process(target=rank_main,
                              args=(r, world_size, str(self.out_dir), cases))
                  for r in range(world_size)]
    for p in self.procs:
      p.start()
    self._results = None

  def results(self, timeout: float = 120.0):
    """Each rank's results (a list of dicts of numpy arrays), once all
    ranks have exited 0. Raises, after terminating the others, when a rank
    fails or the time limit passes."""
    if self._results is None:
      deadline = time.monotonic() + timeout
      try:
        while any(p.is_alive() for p in self.procs):
          failed = [p.exitcode for p in self.procs if p.exitcode not in (None, 0)]
          if failed or time.monotonic() > deadline:
            raise RuntimeError(f"world failed: exit codes "
                               f"{[p.exitcode for p in self.procs]}")
          time.sleep(0.05)
      finally:
        self.close()
      codes = [p.exitcode for p in self.procs]
      if any(codes):
        raise RuntimeError(f"world failed: exit codes {codes}")
      self._results = []
      for r in range(len(self.procs)):
        with np.load(self.out_dir / f"rank{r}.npz") as f:
          self._results.append(dict(f))
    return self._results


  def close(self):
    """Terminate the ranks still running."""
    for p in self.procs:
      if p.is_alive():
        p.terminate()
      p.join(10)
