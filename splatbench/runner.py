"""What every entry shares, and a run of one cell.

An entry is the code a traffic mix's window drives, found by the mix's
`entry` name as `splatbench/entries/<entry>.py`, a module whose `ENTRY`
is a subclass of `Entry` here. Each entry builds the program's state from
--seed in `setup` (kernels loaded, the scene and the cameras made on the
device, the traffic's own shapes warmed; a training entry also runs its
first steps, through the window's own step, and keeps what the check
compares), runs the measured window in `window` (a dict of the window's
measures, such as `mean_ms` or `step_ms`, which the mix's `measures` map
to end-to-end metrics), and in `readings` / `reference_readings` gives
what the program produced and what the plain reference (`reference.py`)
produces from the same seeded inputs, in the same structure, so that
`compare` can set one against the other. The program is the port,
`taichi_gaussian_rasterizer_tpu_torch`; the reference takes nothing it
made.

`run_cell` is one run of a one-card cell, or one rank's part of a
several-card cell, whose ranks `run_dp` starts one process a card.
"""

import os
import socket
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import bounds, harness, reference, scenes

def port():
  import taichi_gaussian_rasterizer_tpu_torch as tgr
  return tgr


class Device:
  """The device a run measures on, and its clocks."""

  def __init__(self, device):
    self.device = torch.device(device)
    self.cuda = self.device.type == "cuda"

  def sync(self):
    if self.cuda:
      torch.cuda.synchronize(self.device)

  def reset_peak(self):
    if self.cuda:
      torch.cuda.reset_peak_memory_stats(self.device)

  def peak(self) -> int:
    return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

  def span(self):
    return _CudaSpan() if self.cuda else _HostSpan()

  def median_ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
    """The median ms of `reps` calls of fn after `warmup` calls, each call
    timed alone (CUDA events on the card)."""
    for _ in range(warmup):
      fn()
    self.sync()
    times = []
    for _ in range(reps):
      s = self.span()
      s.start()
      fn()
      times.append(s.stop())
    return harness.quantile(times, 0.5)


class _CudaSpan:
  def start(self):
    self.a = torch.cuda.Event(enable_timing=True)
    self.b = torch.cuda.Event(enable_timing=True)
    self.a.record()

  def stop(self) -> float:
    self.b.record()
    self.b.synchronize()
    return self.a.elapsed_time(self.b)


class _HostSpan:
  def start(self):
    self.t = time.perf_counter()

  def stop(self) -> float:
    return (time.perf_counter() - self.t) * 1e3


def to_gaussians(tgr, g: Dict):
  return tgr.Gaussians3D(**{k: g[k] for k in scenes.GAUSSIAN_KEYS})


def to_camera(tgr, c: Dict):
  return tgr.CameraParams(projection=c["projection"],
                          T_camera_world=c["T_camera_world"],
                          near_plane=c["near_plane"], far_plane=c["far_plane"],
                          image_size=tuple(c["image_size"]))


def learning_rates(cfg: Dict, median_depth: float) -> Dict[str, float]:
  """The configuration's per-group rates; the position's is scaled by the
  scene's median depth, as 3DGS scales it by the scene's extent."""
  lrs = dict(cfg["learning_rates"])
  lrs["position"] *= median_depth
  return lrs


def make_target(cfg: Dict, channels: int, seed: int, index: int, device):
  w, h = cfg["image_size"]
  gen = scenes.generator(scenes.derive_seed(seed, 100 + index), device)
  return torch.rand((h, w, channels), generator=gen, device=device)


def load_kernels(tgr, dev: Device):
  """Build (first run of a checkout) or load the port's CUDA kernels."""
  if not dev.cuda:
    return
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (backward,
                                                               forward, reduce)
  from taichi_gaussian_rasterizer_tpu_torch.utils.cuda_build import load_all
  load_all([forward.RASTER_FORWARD, backward.RASTER_BACKWARD,
            reduce.SEGMENT_SUM])


class Entry:
  """What the entries share: the cell, the seed, the device and the
  seeded inputs."""

  def __init__(self, cell, seed: int, dev: Device, rank: int = 0):
    self.cell, self.seed, self.dev, self.rank = cell, seed, dev, rank
    self.cfg, self.traffic = cell.config, cell.traffic
    self.tgr = port()
    self.spans: Dict[str, List[float]] = {}
    self.profile: Optional[Dict] = None
    self.frame_ms: List[float] = []

  def make_inputs(self):
    device = self.dev.device
    self.camera, self.gaussians = scenes.make_scene(self.cfg, self.seed, device,
                                                    self.cell.root)
    self.median_depth = scenes.median_depth(self.gaussians, self.camera)
    tr = self.traffic
    self.path = scenes.camera_path(self.camera, tr["views"], tr["max_angle_deg"],
                                   tr["shift_frac"] * self.median_depth,
                                   self.cfg["geometry_seed"], self.seed)
    self.cameras = [to_camera(self.tgr, c) for c in self.path]
    self.config = self.tgr.RasterConfig(**self.cfg.get("raster_config", {}))
    self.use_sh = self.cfg["features"]["kind"] == "sh"

  def render(self, gaussians, view: int):
    return self.tgr.render_gaussians(
        gaussians, self.cameras[view], self.config, use_sh=self.use_sh,
        render_depth=self.cfg["render_depth"])

  def probe_frame(self, gaussians_dict: Dict, view: int) -> SimpleNamespace:
    """A frame of the window's traffic for the per-layer probes: the
    port's inputs to each layer, as `render_gaussians` builds them."""
    tgr = self.tgr
    g = to_gaussians(tgr, gaussians_dict)
    cam = self.cameras[view]
    with torch.no_grad():
      points, depths, _ = tgr.project_to_image(g, cam, self.config)
      feats = (tgr.evaluate_sh_at(g.feature, g.position, cam.camera_position)
               if self.use_sh else g.feature)
      if self.cfg["render_depth"]:
        feats = torch.cat([depths, depths * depths, feats], 1)
      near, far = cam.near_plane, cam.far_plane
      ndc = reference.ndc_depth(torch.clamp(depths, min=near), near, far)[:, 0]
      mapping = tgr.map_to_tiles(points, ndc, cam.image_size, self.config)
    return SimpleNamespace(gaussians=g, camera=cam, points=points, depths=depths,
                           feats=feats.contiguous(), ndc=ndc, mapping=mapping,
                           image_size=cam.image_size, config=self.config,
                           use_sh=self.use_sh, view=view,
                           gaussians_dict=gaussians_dict)

  def work(self, frame) -> Dict:
    """The frame's implementation-independent counts, from the reference's
    own projection, mapping and blend of the same view."""
    r = reference.render(frame.gaussians_dict, self.path[frame.view], self.cfg)
    th, tw = r["mapping"]["tile_shape"]
    return dict(active=r["active"], n_slots=int(r["mapping"]["otp"].shape[0]),
                n_points=int(r["points"].shape[0]),
                n_features=int(r["feats"].shape[1]), n_tiles=th * tw,
                image_size=r["size"])


# -- a run ---------------------------------------------------------------------


def make_entry(cell, seed: int, dev: Device, rank: int = 0) -> Entry:
  """The cell's entry, by the traffic's `entry` name."""
  module = harness.load_part("entries", cell.traffic["entry"], cell.root)
  return module.ENTRY(cell, seed, dev, rank)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             rank: int = 0, t0: Optional[float] = None) -> Dict:
    """One run of a one-process cell (or of one rank of a several-card
    cell): set-up, the window, the per-layer readers with --trace, then
    the check. Returns the pieces of the result line."""
    dev = Device(device)
    entry = make_entry(cell, seed, dev, rank)
    entry.setup()
    dev.sync()
    setup_peak = dev.peak()
    setup_s = None if t0 is None else time.time() - t0
    dev.reset_peak()
    e2e = entry.window(seconds, trace)
    window_peak = dev.peak()
    out = dict(setup_s=setup_s, e2e=e2e, window_peak=window_peak,
               memory_peak_bytes=max(setup_peak, window_peak),
               window_start=getattr(entry, "window_start", None))
    if trace:
      out["profile"] = entry.profile
      if rank == 0:
        out["layers"] = read_layers(cell, entry)
    prog = entry.readings()
    entry.free()
    if dev.cuda:
      torch.cuda.empty_cache()
    ref = entry.reference_readings()
    out["numbers"] = entry.compare(prog, ref)
    return out


def read_layers(cell, entry) -> Dict[str, float]:
  """Each per-layer metric of the cell, by its reader; one that finds
  nothing to read is left out."""
  ctx = LayerContext(entry)
  values = {}
  for m in cell.per_layer:
    reader = harness.load_metric(m["name"], cell.root)
    v = reader.read(ctx)
    if v is not None:
      values[m["name"]] = {"value": v, "unit": m["unit"]}
  return values


class LayerContext:
  """What a per-layer reader may read: the entry's traced profile and
  spans, its untraced frame or step times, a probe frame of the window's
  traffic (built once, on the first view, at the program's current
  parameters) and that frame's work counts (the reference's, built
  once)."""

  def __init__(self, entry):
    self.entry = entry
    self.tgr = entry.tgr
    self.dev = entry.dev
    self.profile = entry.profile
    self.spans = entry.spans
    self.frame_ms = entry.frame_ms
    self.bounds = bounds
    self._frame = None
    self._work = None

  @property
  def frame(self):
    if self._frame is None:
      e = self.entry
      g = e.gaussians if getattr(e, "program", None) is not None else \
          {k: v.detach() for k, v in e.params.tensors.items()}
      self._frame = e.probe_frame(g, 0)
    return self._frame

  @property
  def work(self) -> Dict:
    if self._work is None:
      self._work = self.entry.work(self.frame)
    return self._work


def rank_worker(rank, world, port, device_type, queue, fn, args, hook=None):
  """One rank of a several-card world, in its own process: NCCL on card
  `rank` (gloo on the CPU, for tests), then fn(*args, device, rank) and
  its result to the queue. `hook`, if given, runs first (tests plant
  faults with it)."""
  import datetime
  import traceback
  import torch.distributed as dist
  try:
    if hook is not None:
      hook()
    os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    cuda = device_type == "cuda"
    if cuda:
      torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=180))
    device = f"cuda:{rank}" if cuda else "cpu"
    queue.put((rank, fn(*args, device, rank), None))
  except BaseException:
    queue.put((rank, None, traceback.format_exc()))
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()


def free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def spawn_ranks(world: int, device_type: str, fn, args, hook=None) -> List:
  """fn(*args, device, rank) on `world` ranks, one spawned process each,
  meeting on a TCP store on localhost at a free port, with NCCL kept off
  /dev/shm; every rank's result, rank 0 first. Every process is joined,
  and ended if it outlives the others."""
  import torch.multiprocessing as mp
  ctx = mp.get_context("spawn")
  queue = ctx.SimpleQueue()
  saved = os.environ.get("NCCL_SHM_DISABLE")
  os.environ["NCCL_SHM_DISABLE"] = "1"
  port = free_port()
  procs = [ctx.Process(target=rank_worker,
                       args=(r, world, port, device_type, queue, fn, args, hook))
           for r in range(world)]
  try:
    for p in procs:
      p.start()
  finally:
    if saved is None:
      del os.environ["NCCL_SHM_DISABLE"]
    else:
      os.environ["NCCL_SHM_DISABLE"] = saved
  got, errors = {}, []
  try:
    for _ in range(world):
      rank, result, err = queue.get()
      if err:
        errors.append(f"rank {rank}:\n{err}")
        break
      got[rank] = result
  finally:
    for p in procs:
      p.join(timeout=5 if errors else 120)
    for p in procs:
      if p.is_alive():
        p.terminate()
        p.join(timeout=30)
      if p.is_alive():
        p.kill()
        p.join()
  if errors or len(got) != world:
    raise RuntimeError("a rank failed:\n" + "\n".join(errors))
  return [got[r] for r in range(world)]


def run_dp(cell, seed: int, seconds: float, trace: bool, device_type: str,
           hook=None) -> List[Dict]:
  """`run_cell` on each rank of the cell's world."""
  return spawn_ranks(cell.traffic["ranks"], device_type, run_cell,
                     (cell, seed, seconds, trace), hook)
