"""The port's spans (`utils.tracing`) on the CPU: nothing is recorded, no
hook registered and no `record_function` entered while no profile is
active; under `torch.profiler` every span of a frame and a step is
recorded with its parent and frame, on the profiler's clock, with the
mapper's counts; two gloo ranks record the flat all-reduce's spans."""

import dataclasses

import pytest
import torch

import taichi_gaussian_rasterizer_tpu_torch as tgr
from taichi_gaussian_rasterizer_tpu_torch.ops import mapper
from taichi_gaussian_rasterizer_tpu_torch.optim import FractionalAdam, ParameterClass
from taichi_gaussian_rasterizer_tpu_torch.utils import random_data, tracing

import torch_parallel_workers as workers

CONFIG = tgr.RasterConfig(tile_size=16, points_per_chunk=8)
FRAME = ("tgr.render", "tgr.project", "tgr.sh", "tgr.map", "tgr.map.sync",
         "tgr.raster.fwd", "tgr.raster.bwd", "tgr.reduce.sort", "tgr.project.bwd")


@pytest.fixture(autouse=True)
def empty_buffer():
  tracing.clear()
  yield
  tracing.clear()


def scene(n=300, size=(64, 48)):
  gen = torch.Generator().manual_seed(5)
  cam = random_data.random_camera(gen, image_size=size)
  g = random_data.random_3d_gaussians(gen, n, cam, sh_degree=1)
  return cam, g


def leaves(g):
  return tgr.Gaussians3D(**{f.name: getattr(g, f.name).detach().requires_grad_()
                            for f in dataclasses.fields(g)})


def adam(g):
  keys = [f.name for f in dataclasses.fields(g)]
  return ParameterClass.create({k: getattr(g, k).clone() for k in keys},
                               {k: {"lr": 0.01} for k in keys},
                               optimizer=FractionalAdam)


def train_step(cam, g, params=None):
  """A render, an L1 loss, its backward and (with params) an Adam step."""
  r = tgr.render_gaussians(g, cam, CONFIG, use_sh=True)
  r.image.abs().mean().backward()
  if params is not None:
    grads = {f.name: getattr(g, f.name).grad for f in dataclasses.fields(g)}
    params.step(grads, weight=torch.ones(params.num_points))


def profiled(fn):
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    fn()
  return prof, tracing.records()


def by_name(recs):
  out = {}
  for r in recs:
    out.setdefault(r["name"], []).append(r)
  return out


def test_spans_off_record_nothing_and_touch_nothing(monkeypatch):
  def refuse(*args, **kwargs):
    raise AssertionError("touched while no profile is active")
  monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
  monkeypatch.setattr(torch.profiler, "record_function", refuse)
  monkeypatch.setattr(torch.Tensor, "register_hook", refuse)
  monkeypatch.setattr(torch.cuda, "Event", refuse)
  cam, g = scene()
  params = adam(g)
  g = leaves(g)
  # nor is a count copied (the mapper's overlap total)
  monkeypatch.setattr(torch.Tensor, "clone", refuse)
  train_step(cam, g, params)
  assert all(getattr(g, f.name).grad is not None for f in dataclasses.fields(g))
  assert tracing.records() == []
  assert tracing.span("render") is tracing.span("map")
  assert tracing.current() is None


def test_frame_and_step_spans_nest_and_share_the_frame():
  cam, g = scene()
  params = adam(g)
  g = leaves(g)
  _, recs = profiled(lambda: train_step(cam, g, params))
  names = by_name(recs)
  for name in FRAME + ("tgr.optim.step",):
    # the reduction's sort, then its one block of 9 rows' gather
    want = 2 if name == "tgr.reduce.sort" else 1
    assert len(names[name]) == want, (name, sorted(names))
  one = {k: v[0] for k, v in names.items()}
  render, m = one["tgr.render"], one["tgr.map"]
  assert render["parent"] is None and render["frame"] == render["id"]
  assert one["tgr.map.sync"]["parent"] == m["id"] and m["parent"] == render["id"]
  for name in ("tgr.project", "tgr.sh", "tgr.raster.fwd"):
    assert one[name]["parent"] == render["id"]
  # the backward's spans, on autograd's thread, take the forward's frame
  assert one["tgr.raster.bwd"]["parent"] == render["id"]
  assert all(s["parent"] == one["tgr.raster.bwd"]["id"]
             for s in names["tgr.reduce.sort"])
  assert one["tgr.project.bwd"]["parent"] == render["id"]
  assert {one[n]["frame"] for n in FRAME} == {render["id"]}
  assert one["tgr.project.bwd"]["start_ns"] >= one["tgr.raster.bwd"]["end_ns"]
  step = one["tgr.optim.step"]
  assert step["parent"] is None and step["frame"] == step["id"] != render["id"]
  # no CUDA here: host times only
  assert all(r["device_ms"] is None and r["host_ms"] >= 0 for r in recs)
  # the hooks that closed tgr.project.bwd are gone
  assert all(not getattr(g, f.name)._backward_hooks for f in dataclasses.fields(g))


def test_spans_lie_on_the_profilers_clock():
  cam, g = scene()
  g = leaves(g)
  prof, recs = profiled(lambda: train_step(cam, g))
  events = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
  ranges = {}
  for e in events:
    if e.name.startswith("tgr."):
      ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
  assert set(FRAME) <= set(ranges)

  def inside(e, name):
    return any(s <= e.time_range.start and e.time_range.end <= t
               for s, t in ranges[name])

  # repeat_interleave (the candidate keys) is the mapper's alone
  mapper_ops = [e for e in events if e.name == "aten::repeat_interleave"]
  assert mapper_ops and all(inside(e, "tgr.map") for e in mapper_ops)
  sync = [e for e in events if e.name == "tgr.map.sync"]
  assert sync and all(inside(e, "tgr.map") for e in sync)
  assert all(inside(e, "tgr.render") for e in events if e.name == "tgr.map")


def test_map_counts_candidates_and_overlaps():
  cam, g = scene(n=500)
  with torch.no_grad():
    points, depths, _ = tgr.project_to_image(g, cam, CONFIG)
  box = [None]

  def run():
    box[0] = tgr.map_to_tiles(points, depths, cam.image_size, CONFIG)

  _, recs = profiled(run)
  (m,) = [r for r in recs if r["name"] == "tgr.map"]
  fp = mapper._footprint(points, cam.image_size, CONFIG.tile_size,
                         CONFIG.alpha_threshold, CONFIG.max_tile_span)
  assert m["counts"]["candidates"] == int((fp["span_x"] * fp["span_y"]).sum())
  assert m["counts"]["overlaps"] == int(box[0].total_overlaps)
  assert 0 < m["counts"]["overlaps"] < m["counts"]["candidates"]
  assert isinstance(m["counts"]["overlaps"], int)


@pytest.mark.parametrize("gather", [False, True])
def test_sh_counts_points_and_kernel_points(gather):
  """tgr.sh counts the rows shaded; on the CPU none by the CUDA kernel."""
  cam, g = scene()
  indexes = torch.arange(0, 300, 7) if gather else None
  _, recs = profiled(lambda: tgr.evaluate_sh_at(
      g.feature, g.position, cam.camera_position, indexes=indexes))
  (shade,) = [r for r in recs if r["name"] == "tgr.sh"]
  assert shade["counts"] == dict(points=43 if gather else 300, kernel_points=0)


def test_backward_tail_closes_for_part_of_the_gradients():
  """A gradient taken for the positions alone: the other tensors' hooks
  never fire, and the end of the backward pass closes tgr.project.bwd."""
  cam, g = scene()
  g = leaves(g)

  def run():
    r = tgr.render_gaussians(g, cam, CONFIG, use_sh=True)
    torch.autograd.grad(r.image.sum(), [g.position])

  _, recs = profiled(run)
  (tail,) = [r for r in recs if r["name"] == "tgr.project.bwd"]
  (render,) = [r for r in recs if r["name"] == "tgr.render"]
  assert tail["frame"] == render["id"]
  assert all(not getattr(g, f.name)._backward_hooks for f in dataclasses.fields(g))


def test_serving_frames_and_the_buffer():
  """A render without autograd records no backward spans and registers no
  hook; the buffer holds at most CAPACITY records and clear() empties it."""
  cam, g = scene()

  def serve():
    with torch.no_grad():
      for _ in range(3):
        tgr.render_gaussians(g, cam, CONFIG, use_sh=True)

  _, recs = profiled(serve)
  names = by_name(recs)
  assert len(names["tgr.render"]) == 3 and "tgr.raster.bwd" not in names
  assert len({r["frame"] for r in recs}) == 3
  assert tracing._records.maxlen == tracing.CAPACITY
  tracing.clear()
  assert tracing.records() == []


def test_two_gloo_ranks_record_the_flat_all_reduce(tmp_path):
  world = workers.World(2, tmp_path, cases=["spans"])
  for rank in world.results(timeout=120.0):
    names = list(rank["spans.names"])
    parents = rank["spans.parents"]
    assert names.count("tgr.dp.pack") == 1 and names.count("tgr.dp.allreduce") == 1
    pack = names.index("tgr.dp.pack")
    assert parents[names.index("tgr.dp.allreduce")] == pack
    assert parents[pack] == -1
    assert "tgr.optim.step" in names and "tgr.project.bwd" in names
