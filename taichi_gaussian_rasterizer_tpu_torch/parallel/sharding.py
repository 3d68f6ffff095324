"""Multi-GPU execution on torch.distributed (port of
`taichi_gaussian_rasterizer_tpu.parallel.sharding`).

The three axes of the JAX module, one process per rank (SPMD, e.g. under
`torchrun --nproc-per-node=N`):

* **Camera data parallelism** (`dp_train_step`): each rank renders its own
  cameras against replicated parameters (forward, backward and the
  gradient reduction through the raster kernels), the gradients, loss and
  visibility are all-reduced in one flat buffer, and every rank applies
  the same optimizer step, so the replicas stay equal bit for bit.
* **Tile parallelism** (`tp_rasterize`, `tp_train_step`): one frame split
  into horizontal tile-aligned stripes, one a rank. Each rank maps and
  rasterizes its stripe with the gaussians' mean y shifted into the
  stripe's frame; the forward needs no collective.
* **Point parallelism** (`pp_project`): each rank projects its block of
  the gaussians, and an all-gather gives every rank all of them.

A mesh (`Mesh`) is a process group: NCCL with one card a rank, or gloo
on the CPU. shard_map's `psum`/`pmean` become `all_reduce`, and the
all-gather that `pp_project`'s replicated outputs imply becomes
`all_gather`.

Gradient convention. JAX differentiates the global program. Here a tensor
that is replicated across the ranks carries the **global** gradient on
every rank:

* a replicated input of a per-rank computation enters through an identity
  whose backward all-reduces (sums) its gradient over the ranks, which is
  shard_map's transpose of a replicated input (`tp_rasterize`'s points and
  features, `pp_project`'s gaussians and camera);
* a gathered output is replicated, so the gradient arriving at it is
  already global, and the gather's backward takes this rank's rows of it
  (`pp_project`).

Each rank's loss on its own stripe adds up to the global loss, so
`local_loss.backward()` on every rank gives each replicated input its
global gradient. Every rank must run that backward, because it holds a
collective. The training steps differentiate locally and then reduce once.

The tile-parallel functions are a per-stripe body (`tp_rasterize_stripe`,
`tp_train_stripe`) and a collective step; a single process can loop a
body over the stripes and add the results, which is what the
distributed function computes.

Not carried over, because they exist for XLA's static shapes or jit:

* `capacity` and `local_capacity`: the port's mapper is exact and sizes
  its buffers from its own count.
* Rendering every stripe at the largest stripe height, and `row_mask`:
  each stripe renders at its own height, and the rows past it in the
  returned block are zeros (JAX renders the next stripes' content there).
  `assemble_stripes` drops those rows either way, and the loss needs no
  mask.
* `stripe_select`'s padding with non-relevant indices: the selection has
  the length it needs.
* jit, and the builders' `axis_name`: a port mesh has one axis, named in
  `Mesh.axis_name`.
"""

import dataclasses
import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import RasterConfig
from ..data_types import Gaussians3D
from ..models.renderer import render_gaussians
from ..ops import lib
from ..ops.mapper import cdiv, map_to_tiles
from ..ops.projection import CameraParams, project_points
from ..ops.raster import rasterize
from ..optim import ParameterClass
from ..utils import tracing

GAUSSIAN_KEYS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


@dataclasses.dataclass(frozen=True)
class Mesh:
  """A one-axis device mesh: a process group and this process's place in
  it."""
  group: dist.ProcessGroup
  rank: int                  # this process's rank in the group
  size: int
  axis_name: str
  device: torch.device       # where this rank's tensors live


def _local_rank() -> int:
  if "LOCAL_RANK" in os.environ:
    return int(os.environ["LOCAL_RANK"])
  if dist.is_initialized():
    return dist.get_rank()
  return int(os.environ.get("RANK", "0"))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> Optional[Mesh]:
  """A mesh over the first `n_devices` ranks (all when None).

  Uses the default process group when one is initialised, otherwise
  initialises it from `env://` (what `torchrun` sets: MASTER_ADDR,
  MASTER_PORT, RANK, WORLD_SIZE). By default each rank takes the card of
  its local rank, `cuda:<LOCAL_RANK>`, and the group is NCCL; with
  `device="cpu"` it is gloo. The group's backend must be the device's:
  nothing falls back from NCCL to gloo.

  Every rank must call it (a subgroup is made collectively); a rank
  outside the first `n_devices` gets None.
  """
  device = torch.device("cuda" if device is None else device)
  backend = "gloo" if device.type == "cpu" else "nccl"
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device for an NCCL mesh; pass device='cpu' "
                       "for a gloo mesh on the CPU")
  if device.type == "cuda" and device.index is None:
    device = torch.device("cuda", _local_rank() % torch.cuda.device_count())
  if device.type == "cuda":
    torch.cuda.set_device(device)
  if not dist.is_initialized():
    dist.init_process_group(backend, init_method="env://")
  if backend not in dist.get_backend():
    raise ValueError(f"the process group's backend is {dist.get_backend()}; "
                     f"a mesh on {device.type} needs {backend}")
  world = dist.get_world_size()
  n = world if n_devices is None else n_devices
  if not 1 <= n <= world:
    raise ValueError(f"need {n} ranks, have {world}")
  group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
  if dist.get_rank() >= n:
    return None
  return Mesh(group, dist.get_rank(group), n, axis_name, device)


def _tree_map(tree, fn):
  """fn on every tensor of tensors nested in dicts, lists, tuples
  (named ones too) and dataclasses (a ParameterClass, Gaussians3D, a
  CameraParams); other leaves are kept."""
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, dict):
    return {k: _tree_map(v, fn) for k, v in tree.items()}
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return type(tree)(*(_tree_map(v, fn) for v in tree))
  if isinstance(tree, (list, tuple)):
    return type(tree)(_tree_map(v, fn) for v in tree)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: _tree_map(getattr(tree, f.name), fn)
        for f in dataclasses.fields(tree) if f.init})
  return tree


def replicate(tree, mesh: Mesh):
  """Rank 0's tensors of `tree` on every rank, on `mesh.device` (a
  broadcast; every rank passes a tree of the same structure, shapes and
  dtypes, e.g. a ParameterClass with its optimizer state)."""
  def broadcast(t):
    t = t.detach().to(mesh.device, memory_format=torch.contiguous_format,
                      copy=True)
    dist.broadcast(t, group=mesh.group, group_src=0)
    return t
  return _tree_map(tree, broadcast)


def shard_leading(tree, mesh: Mesh):
  """This rank's contiguous block of each tensor's leading axis, on
  `mesh.device`. The leading size must divide by the mesh size."""
  def block(t):
    if t.shape[0] % mesh.size:
      raise ValueError(f"leading size {t.shape[0]} does not divide into "
                       f"{mesh.size} ranks")
    b = t.shape[0] // mesh.size
    return t[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device)
  return _tree_map(tree, block)


def _all_reduce_flat(tensors: Sequence[torch.Tensor],
                     mesh: Mesh) -> List[torch.Tensor]:
  """Each tensor summed over the ranks, with one all_reduce: flattened into
  one buffer of their promoted dtype, then split and cast back. Under a
  torch.profiler profile the call is the span `tgr.dp.pack` of
  `utils.tracing`, and the all_reduce in it `tgr.dp.allreduce`."""
  with tracing.span("dp.pack"):
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    with tracing.span("dp.allreduce"):
      dist.all_reduce(flat, group=mesh.group)
    out, start = [], 0
    for t in tensors:
      out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
      start += t.numel()
    return out


class _Replicated(torch.autograd.Function):
  """Identity on replicated inputs; the backward sums their gradients over
  the ranks (shard_map's transpose of a replicated input)."""

  @staticmethod
  def forward(ctx, mesh, *tensors):
    ctx.mesh = mesh
    return tuple(t.view_as(t) for t in tensors)

  @staticmethod
  def backward(ctx, *grads):
    need = [i for i in range(len(grads)) if ctx.needs_input_grad[i + 1]]
    out = [None] * len(grads)
    if need:
      for i, g in zip(need, _all_reduce_flat([grads[i] for i in need],
                                             ctx.mesh)):
        out[i] = g
    return (None, *out)


class _GatherRows(torch.autograd.Function):
  """All-gather of the ranks' row blocks (block i holds rows [i * b,
  min((i + 1) * b, n)) of n); the backward takes this rank's rows of the
  incoming gradient, which is global because the output is replicated."""

  @staticmethod
  def forward(ctx, mesh, block, n, b):
    ctx.rows = (mesh.rank * b, mesh.rank * b + block.shape[0])
    padded = F.pad(block, (0, 0, 0, b - block.shape[0])).contiguous()
    parts = [torch.empty_like(padded) for _ in range(mesh.size)]
    dist.all_gather(parts, padded, group=mesh.group)
    return torch.cat(parts)[:n]

  @staticmethod
  def backward(ctx, grad):
    lo, hi = ctx.rows
    return None, grad[lo:hi], None, None


# ---------------------------------------------------------------------------
# camera data parallelism
# ---------------------------------------------------------------------------


def dp_train_step(mesh: Mesh,
                  config: RasterConfig,
                  image_size: Tuple[int, int],
                  local_batch: int = 1,
                  use_sh: bool = False,
                  depth_range: Tuple[float, float] = (0.1, 1000.0)):
  """A data-parallel 3D training step.

  The returned function has signature
    step(params: ParameterClass, projections (local_batch, 4),
         t_camera_worlds (local_batch, 4, 4),
         targets (local_batch, H, W, 3)) -> (params, loss)
  with this rank's block of the cameras and targets (`shard_leading`) and
  the replicated parameters (`replicate`). Per local camera it renders,
  takes the MSE and runs its backward (the loss is the mean over the local
  cameras); then one all_reduce averages the gradients and the loss over
  the ranks and sums the per-point visibility, and `params.step` runs
  with that visibility, or with unit weights when the config computes
  none. The step updates `params` in place; every rank applies the same
  values. `depth_range` is the cameras' (near, far) clip range.
  """
  near, far = depth_range
  with_vis = config.compute_visibility or config.compute_point_heuristic

  def step(params: ParameterClass, projections, t_cams, targets):
    if projections.shape[0] != local_batch:
      raise ValueError(f"{projections.shape[0]} cameras on this rank, "
                       f"local_batch {local_batch}")
    leaves = {k: params.tensors[k].detach().requires_grad_()
              for k in GAUSSIAN_KEYS}
    gaussians = Gaussians3D(**leaves)
    loss_sum, vis = 0.0, 0.0
    for proj, t_cam, target in zip(projections, t_cams, targets):
      camera = CameraParams(projection=proj, T_camera_world=t_cam,
                            near_plane=near, far_plane=far,
                            image_size=image_size)
      r = render_gaussians(gaussians, camera, config, use_sh=use_sh)
      mse = torch.mean((r.image - target) ** 2)
      (mse / local_batch).backward()
      loss_sum = loss_sum + mse.detach()
      if r.point_visibility is not None:
        vis = vis + r.point_visibility
    parts = [loss_sum / local_batch] + [leaves[k].grad for k in GAUSSIAN_KEYS]
    if with_vis:
      parts.append(vis)
    loss, *reduced = _all_reduce_flat(parts, mesh)
    grads = {k: g / mesh.size for k, g in zip(GAUSSIAN_KEYS, reduced)}
    if with_vis:
      params.step(grads, visibility=reduced[-1])
    else:
      params.step(grads, weight=torch.ones(params.num_points,
                                           dtype=torch.float32,
                                           device=params.device))
    return params, loss / mesh.size

  return step


# ---------------------------------------------------------------------------
# tile parallelism (one frame split into image stripes over the mesh)
# ---------------------------------------------------------------------------


def stripe_select(points: torch.Tensor, y0, stripe_h, local_points: int,
                  alpha_threshold: float):
  """Indices of the (at most local_points) gaussians whose footprint can
  touch the stripe [y0, y0 + stripe_h), in index order, so that the
  stripe's mapper sees only its own stripe's gaussians.

  The y-extent test is the ellipse-AABB bound of the mapper's footprint
  (ops/mapper._footprint), so selection keeps every gaussian that reaches
  a pixel of the stripe above the alpha threshold. (The stripe's mapper
  can also accept one whose footprint lies wholly above or below the
  stripe, as the full-frame mapper does at its image's edge: it keeps a
  span of one tile row there and tests the tile against the ellipse's
  oriented box. Such a gaussian is under the threshold at every pixel,
  so leaving it out changes no pixel.) Returns (sel (<= local_points,)
  int64 indices, n_dropped () int64: the count of relevant gaussians
  beyond local_points, 0 when the selection is complete)."""
  my = points[:, 1]
  ax, ay = points[:, 2], points[:, 3]
  sx, sy = points[:, 4], points[:, 5]
  alpha = points[:, 6]
  gs = lib.gaussian_scale_factor(alpha, alpha_threshold)
  r0 = torch.clamp(sx * gs, min=1e-12)
  r1 = torch.clamp(sy * gs, min=1e-12)
  ext_y = torch.sqrt((ay * r0) ** 2 + (ax * r1) ** 2)
  relevant = ((alpha > alpha_threshold) & (my + ext_y > y0)
              & (my - ext_y < y0 + stripe_h))
  sel = torch.nonzero(relevant)[:, 0]
  n_dropped = torch.clamp(relevant.sum() - local_points, min=0)
  return sel[:local_points], n_dropped


def stripe_row_loads(points2d: torch.Tensor, depth: torch.Tensor,
                     image_size: Tuple[int, int],
                     config: RasterConfig) -> np.ndarray:
  """The per-tile-row overlap counts of one frame, the load statistic that
  balanced stripes partition on: one full-frame mapping. Returns
  (n_tile_rows,) numpy int64."""
  mapping = map_to_tiles(points2d, depth, image_size, config)
  th, tw = mapping.tile_shape
  tiles = mapping.overlap_to_tile.to(torch.int64)
  tiles = tiles[tiles < th * tw]              # drop the rejected candidates
  return torch.bincount(tiles // tw, minlength=th).cpu().numpy().astype(np.int64)


def balance_stripe_rows(row_loads, d: int) -> Tuple[int, ...]:
  """Optimal contiguous partition of tile rows into d stripes minimizing
  the max per-stripe load (binary search on the bottleneck + greedy
  feasibility). Returns a tuple of d per-stripe tile-row counts (each
  >= 1, summing to len(row_loads)) for tp_rasterize/tp_train_step's
  stripe_rows argument. Loads are per scene: re-probe on drift. One
  stripe takes every row (the JAX function fails its assert there)."""
  loads = np.asarray(row_loads, np.int64)
  n = len(loads)
  if not n >= d >= 1:
    raise ValueError(f"need >= {d} tile rows, have {n}")
  if d == 1:
    return (n,)

  def partition(cap):
    # greedy: start a new stripe when adding the row would exceed cap,
    # or when the remaining rows are needed one-per-remaining-stripe
    counts, cur, used = [], 0, 0
    for i, v in enumerate(loads):
      must_break = (n - i) == (d - len(counts))  # reserve 1 row/stripe
      if cur > 0 and (used + v > cap or must_break):
        counts.append(cur)
        cur, used = 0, 0
        if len(counts) == d - 1:
          counts.append(n - i)
          return counts if max(
              loads[n - counts[-1]:].sum(), 0) <= cap else None
      cur += 1
      used += v
    counts.append(cur)
    return counts if len(counts) <= d else None

  lo, hi = int(loads.max()), int(loads.sum())
  best = None
  while lo <= hi:
    mid = (lo + hi) // 2
    p = partition(mid)
    if p is not None:
      best, hi = p, mid - 1
    else:
      lo = mid + 1
  assert best is not None
  # pad to exactly d stripes by splitting multi-row stripes (a split
  # never raises the bottleneck)
  while len(best) < d:
    i = int(np.argmax(best))
    assert best[i] >= 2
    best[i], split = best[i] - best[i] // 2, best[i] // 2
    best.insert(i + 1, split)
  return tuple(int(c) for c in best)


def stripe_offsets_px(stripe_rows: Tuple[int, ...], tile_size: int):
  """(y0_px per stripe, height_px per stripe, max height_px)."""
  heights = [r * tile_size for r in stripe_rows]
  y0s, acc = [], 0
  for hpx in heights:
    y0s.append(acc)
    acc += hpx
  return tuple(y0s), tuple(heights), max(heights)


def assemble_stripes(stack: torch.Tensor, stripe_rows: Tuple[int, ...],
                     tile_size: int) -> torch.Tensor:
  """Reassemble stacked stripe blocks: stack is (d * max_px, W, ...),
  stripe i's render in rows [i * max_px, i * max_px + h_i); the rows
  beyond h_i are dropped."""
  _, heights, max_px = stripe_offsets_px(stripe_rows, tile_size)
  return torch.cat([stack[i * max_px:i * max_px + hpx]
                    for i, hpx in enumerate(heights)])


def _stripe_rows(image_size, tile_size: int, d: int,
                 stripe_rows: Optional[Tuple[int, ...]]) -> Tuple[int, ...]:
  """The equal split when stripe_rows is None; checks a given one."""
  h = image_size[1]
  if stripe_rows is None:
    if h % (d * tile_size):
      raise ValueError(
          f"image height {h} must split into {d} tile-aligned stripes "
          f"(multiple of {d * tile_size}); pass stripe_rows= for uneven splits")
    return (h // (d * tile_size),) * d
  if len(stripe_rows) != d or min(stripe_rows) < 1:
    raise ValueError(f"stripe_rows {stripe_rows} must hold {d} counts >= 1")
  if sum(stripe_rows) * tile_size != h:
    raise ValueError(f"stripe_rows {stripe_rows} x tile_size {tile_size} != "
                     f"image height {h}")
  return tuple(stripe_rows)


def _stripe(stripe_rows, tile_size: int, index: int):
  y0s, heights, max_px = stripe_offsets_px(stripe_rows, tile_size)
  return y0s[index], heights[index], max_px


def _shift_y(points: torch.Tensor, y0) -> torch.Tensor:
  """The packed points with their mean y in a stripe's frame."""
  return torch.cat([points[:, :1], points[:, 1:2] - y0, points[:, 2:]], dim=1)


def tp_rasterize_stripe(points: torch.Tensor, depth: torch.Tensor,
                        features: torch.Tensor, config: RasterConfig,
                        image_size: Tuple[int, int],
                        stripe_rows: Tuple[int, ...], index: int):
  """Stripe `index` of tp_rasterize: the mapper and the raster kernels on
  the stripe, at its own height, with the mean y shifted into its frame.
  Returns (image (max_px, W, F), weight (max_px, W), this stripe's
  visibility (N,) or None), the rows past the stripe's height zero."""
  y0, h, max_px = _stripe(stripe_rows, config.tile_size, index)
  out = rasterize(_shift_y(points, y0), depth, features,
                  (image_size[0], h), config)
  image = F.pad(out.image, (0, 0, 0, 0, 0, max_px - h))
  weight = F.pad(out.image_weight, (0, 0, 0, max_px - h))
  return image, weight, out.visibility


def tp_rasterize(mesh: Mesh, config: RasterConfig,
                 image_size: Tuple[int, int],
                 stripe_rows: Optional[Tuple[int, ...]] = None):
  """A tile-parallel rasterizer for ONE frame.

  The image is split into `mesh.size` horizontal tile-aligned stripes
  (equal ones, or `stripe_rows` tile rows each, from balance_stripe_rows);
  each rank renders its own (`tp_rasterize_stripe`). The stripe shift
  re-rounds each mean's offset inside its tile, `(mean_y - y0) -
  tile_origin` against `mean_y - global_origin`: exact where mean_y >= y0,
  not always for points above the stripe, so a stripe agrees with the
  full-frame render to rounding, not bit for bit.

  The returned function:
    tp(gaussians2d (N, 7), depth (N,), features (N, F))
      -> (image block (max_px, W, F), weight block (max_px, W),
          visibility (N,) summed over the ranks, or None)

  The blocks are this rank's stripe; stacked in rank order (d * max_px
  rows) `assemble_stripes` gives the (H, W, ...) image. Visibility comes
  with config.compute_visibility (or compute_point_heuristic), summed
  over the ranks. The forward holds no other collective; under backward,
  points and features receive the gradient summed over the ranks.
  """
  stripe_rows = _stripe_rows(image_size, config.tile_size, mesh.size,
                             stripe_rows)

  def tp(points, depth, features):
    points, features = _Replicated.apply(mesh, points, features)
    image, weight, vis = tp_rasterize_stripe(points, depth, features, config,
                                             image_size, stripe_rows,
                                             mesh.rank)
    if vis is not None:
      (vis,) = _all_reduce_flat([vis], mesh)
    return image, weight, vis

  return tp


def tp_train_stripe(points: torch.Tensor, depth: torch.Tensor,
                    features: torch.Tensor, target: torch.Tensor,
                    config: RasterConfig, image_size: Tuple[int, int],
                    local_points: int, stripe_rows: Tuple[int, ...],
                    index: int):
  """Stripe `index` of tp_train_step: stripe_select, the stripe's render
  of the selected gaussians (the gathers' backward scatter-adds into the
  full N), its summed squared error against its own target rows, and the
  backward. Returns (loss, grad_points (N, 7), grad_features (N, F),
  heuristics (N, 2) or None, visibility (N,) or None, n_dropped), this
  stripe's share: their sums over the stripes are the step's."""
  y0, h, _ = _stripe(stripe_rows, config.tile_size, index)
  with_heur = config.compute_point_heuristic
  with_vis = config.compute_visibility or with_heur
  sel, n_dropped = stripe_select(points.detach(), y0, h, local_points,
                                 config.alpha_threshold)
  n = points.shape[0]
  leaves = [points.detach().requires_grad_(),
            features.detach().requires_grad_()]
  sinks = {}
  if with_heur:
    leaves.append(points.new_zeros(n, 2, requires_grad=True))
    sinks["heuristic_sink"] = leaves[-1].index_select(0, sel)
  if with_vis:
    leaves.append(points.new_zeros(n, requires_grad=True))
    sinks["visibility_sink"] = leaves[-1].index_select(0, sel)
  out = rasterize(_shift_y(leaves[0].index_select(0, sel), y0),
                  depth.index_select(0, sel), leaves[1].index_select(0, sel),
                  (image_size[0], h), config, **sinks)
  loss = torch.sum((out.image - target[y0:y0 + h]) ** 2)
  grads = torch.autograd.grad(loss, leaves, allow_unused=True)
  gp, gf, *rest = [torch.zeros_like(x) if g is None else g
                   for g, x in zip(grads, leaves)]
  heur = rest.pop(0) if with_heur else None
  vis = rest.pop(0) if with_vis else None
  return loss.detach(), gp, gf, heur, vis, n_dropped


def tp_train_step(mesh: Mesh, config: RasterConfig,
                  image_size: Tuple[int, int],
                  local_points: int,
                  stripe_rows: Optional[Tuple[int, ...]] = None):
  """A tile-parallel TRAINING step for ONE frame: the forward and backward
  raster pipeline split into image stripes, with the training sinks
  (per-point heuristics and visibility) delivered as in the single-card
  trainer.

  Each rank selects its stripe's (at most `local_points`) relevant
  gaussians, so its mapper, sort and kernels see about 1/mesh of the
  frame, and computes its stripe's summed squared error and gradients
  (`tp_train_stripe`). Then one all_reduce over a flat buffer sums the
  loss, the per-point gradients, heuristics and visibility and the
  dropped counts over the ranks.

  The returned function:
    step(points2d (N, 7), depth (N,), features (N, F), target (H, W, F))
      -> (loss, (grad_points, grad_features), heuristics (N, 2) | None,
          visibility (N,) | None, overflow () int64)

  on every rank. heuristics/visibility follow config.compute_point_heuristic
  / compute_visibility. overflow is the total count of gaussians dropped
  because a stripe had more than local_points relevant ones (0 =
  complete; otherwise raise local_points). stripe_rows: as in
  tp_rasterize.
  """
  stripe_rows = _stripe_rows(image_size, config.tile_size, mesh.size,
                             stripe_rows)

  def step(points, depth, features, target):
    loss, gp, gf, heur, vis, n_dropped = tp_train_stripe(
        points, depth, features, target, config, image_size, local_points,
        stripe_rows, mesh.rank)
    parts = [p for p in (loss, gp, gf, heur, vis, n_dropped) if p is not None]
    loss, gp, gf, *rest = _all_reduce_flat(parts, mesh)
    heur = rest.pop(0) if heur is not None else None
    vis = rest.pop(0) if vis is not None else None
    return loss, (gp, gf), heur, vis, rest.pop(0)

  return step


# ---------------------------------------------------------------------------
# point parallelism (projection sharded over the gaussian axis)
# ---------------------------------------------------------------------------


def pp_project(mesh: Mesh, config: RasterConfig,
               image_size: Tuple[int, int],
               depth_range: Tuple[float, float] = (0.1, 1000.0)):
  """A point-sharded projection: each rank projects its contiguous block
  of the gaussians (the last blocks are shorter when N does not divide)
  and one all_gather gives every rank all N.

  The returned function:
    project(gaussians (Gaussians3D, replicated), projection (4,),
            t_cam (4, 4)) -> (points (N, 7), depth (N, 1), in_view (N,))

  Differentiable: the gathered outputs' backward takes this rank's rows,
  and the gaussians' and camera's gradients are summed over the ranks."""

  def project(gaussians: Gaussians3D, projection, t_cam):
    n = gaussians.position.shape[0]
    b = cdiv(n, mesh.size)
    lo, hi = min(mesh.rank * b, n), min((mesh.rank + 1) * b, n)
    *shape_tensors, projection, t_cam = _Replicated.apply(
        mesh, *gaussians.shape_tensors(), projection, t_cam)
    pts, depth, in_view = project_points(
        *(t[lo:hi] for t in shape_tensors), t_cam, projection, image_size,
        depth_range, blur_cov=config.blur_cov,
        clamp_margin=config.clamp_margin,
        alpha_threshold=config.alpha_threshold)
    rows = torch.cat([pts, depth, in_view.to(pts.dtype)[:, None]], dim=1)
    rows = _GatherRows.apply(mesh, rows, n, b)
    return rows[:, :7], rows[:, 7:8], rows[:, 8].detach() > 0

  return project
