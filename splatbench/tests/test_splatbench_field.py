"""The Feature 3DGS cell, `feat3dgs-bicycle6m.train`: found by name; a
small run on the CPU is correct by the cell's own limits and its traced
window feeds every per-layer reader it lists; the new readers on records
written out by hand; the TF32 control fails the limits; each fault the
cell can have turns a small run's `correct` false; a port that cannot
blend point features stops the set-up at once."""

import math
import time
from types import SimpleNamespace

import pytest
import torch

from splatbench import field_bounds, harness, runner
from splatbench.tests import faults, field_faults, small
import taichi_gaussian_rasterizer_tpu_torch as tgr
from taichi_gaussian_rasterizer_tpu_torch.models import renderer
from taichi_gaussian_rasterizer_tpu_torch.optim import ParameterClass
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing

CELL = "feat3dgs-bicycle6m.train"
# the cell's per-layer metrics: new, and those of bicycle6m.train it joins
NEW = ("raster_fwd_span_ms.train", "field_decode_span_ms.field",
       "field_decode_roofline.field")
JOINED = ("raster_bwd_roofline.train", "optim_ms.train", "device_idle.train",
          "project_bwd_span_ms.train", "raster_bwd_span_ms.train",
          "reduce_sort_ms.train", "optim_span_ms.train", "sh_bwd_span_ms.train")


def small_field_cell(channels=128):
  cell = small.small_cell(CELL)
  cell.config["field"] = dict(cell.config["field"], channels=channels,
                              teacher_size=[60, 45])
  return cell


def test_the_cell_is_found_by_name():
  cell = harness.Cell(harness.load_benchmark(), CELL)
  assert cell.config["name"] == "feat3dgs-bicycle6m" and cell.chips == 1
  assert cell.traffic["entry"] == "field_train" and cell.traffic["targets"] == 4
  assert set(cell.limits) == {"loss_gap_first", "grad_gap", "change_gap"}
  assert [m["name"] for m in cell.end_to_end] == ["train_step_ms", "train_peak_gib",
                                                  "setup_s"]
  assert [cell.measure(m["name"]) for m in cell.end_to_end] == [
      "step_ms", "peak_gib", "setup_s"]
  assert {m["name"] for m in cell.per_layer} == set(NEW + JOINED)
  assert all(m["moves"] == "train_step_ms" and m["workloads"][-1] == CELL
             for m in cell.per_layer)
  f = cell.config["field"]
  assert (f["channels"], f["decoded_channels"], f["teacher_size"]) == (128, 512, [1024, 680])
  assert cell.config["scene"]["points"] == 6100000
  assert cell.config["image_size"] == [2048, 1361]
  bench = harness.load_benchmark()
  train = {m["name"] for m in harness.Cell(bench, "bicycle6m.train").per_layer}
  assert set(JOINED) | {"raster_fwd_span_ms.train"} <= train
  for name in ("bicycle6m.serve", "bicycle6m.dp4-train"):
    assert not set(NEW + JOINED) & {m["name"] for m in harness.Cell(bench, name).per_layer}


def test_a_small_run_is_correct_and_feeds_every_reader(monkeypatch):
  cell = small_field_cell()
  dev = runner.Device("cpu")
  entry = runner.make_entry(cell, 2**40 + 17, dev)
  entry.setup()
  out = entry.window(0.3, True)
  assert out["step_ms"] > 0 and out["attempted"] >= cell.traffic["trace_steps"]
  # the port's records of the traced steps, with their host ms as device ms
  recs = [dict(r, device_ms=r["host_ms"]) for r in tracing.records()]
  names = {r["name"] for r in recs}
  assert {"tgr.field.decode", "tgr.field.decode.bwd", "tgr.raster.fwd",
          "tgr.raster.bwd", "tgr.reduce.sort", "tgr.optim.step",
          "tgr.project.bwd"} <= names
  # no SH kernel on the CPU: tgr.sh.bwd is a span of the card's path alone
  recs.append(dict(recs[-1], name="tgr.sh.bwd", id=-1))
  monkeypatch.setattr(tracing, "records", lambda: recs)
  entry.profile = dict(window_s=1.0, busy_s=0.9)
  layers = runner.read_layers(cell, entry)
  assert set(layers) == set(NEW + JOINED), layers
  assert all(math.isfinite(v["value"]) and v["value"] > 0 for v in layers.values())
  assert layers["device_idle.train"]["value"] == pytest.approx(10.0)
  prog = entry.readings()
  assert {"semantic_feature", "decoder_weight", "decoder_bias"} <= set(prog["g1"])
  entry.free()
  checks = harness.judge(entry.compare(prog, entry.reference_readings()), cell.limits)
  assert harness.all_within(checks), checks


def rec(name, id, frame, parent=None, device_ms=1.0, **counts):
  return dict(name="tgr." + name, id=id, parent=parent, frame=frame, start_ns=0,
              end_ns=1, host_ms=1e-6, device_ms=device_ms, counts=counts)


DECODE = dict(pixels=1024 * 680, in_channels=128, out_channels=512)
# two training steps: the render frames 1 and 10 (forward, backward, the
# reduction's sort and three gathers), the decoder's frames 5 and 15, the
# optimizer's steps 8 and 18
RECORDS = [
    rec("render", 1, 1, device_ms=40.0), rec("raster.fwd", 2, 1, 1, 16.0, channels=131),
    rec("raster.bwd", 3, 1, 1, 50.0), rec("reduce.sort", 4, 1, 3, 4.0, rows=137, chunks=3),
    rec("reduce.sort", 41, 1, 3, 2.0), rec("reduce.sort", 42, 1, 3, 2.0),
    rec("reduce.sort", 43, 1, 3, 1.0),
    rec("field.decode", 5, 5, None, 2.0, **DECODE),
    rec("field.decode.bwd", 6, 5, 5, 4.0, **DECODE),
    rec("optim.step", 8, 8, None, 50.0),
    rec("render", 10, 10, device_ms=42.0), rec("raster.fwd", 11, 10, 10, 18.0, channels=131),
    rec("raster.bwd", 12, 10, 10, 60.0),
    rec("reduce.sort", 13, 10, 12, 5.0, rows=137, chunks=3),
    rec("reduce.sort", 131, 10, 12, 2.0), rec("reduce.sort", 132, 10, 12, 2.0),
    rec("reduce.sort", 133, 10, 12, 2.0),
    rec("field.decode", 15, 15, None, 3.0, **DECODE),
    rec("field.decode.bwd", 16, 15, 15, 5.0, **DECODE),
    rec("optim.step", 18, 18, None, 54.0),
]


def test_readers_on_records_written_out(monkeypatch):
  monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in RECORDS])
  cfg = harness.Cell(harness.load_benchmark(), CELL).config
  ctx = SimpleNamespace(entry=SimpleNamespace(cfg=cfg), profile=None)
  spans = NEW + ("raster_bwd_span_ms.train", "reduce_sort_ms.train",
                 "optim_span_ms.train")
  read = {n: harness.load_metric(n).read for n in spans}
  assert read["raster_fwd_span_ms.train"](ctx) == pytest.approx(17.0)
  assert read["raster_bwd_span_ms.train"](ctx) == pytest.approx(55.0)
  # the sort and the three gathers of a step, summed
  assert read["reduce_sort_ms.train"](ctx) == pytest.approx(10.0)
  assert read["field_decode_span_ms.field"](ctx) == pytest.approx(7.0)
  assert read["optim_span_ms.train"](ctx) == pytest.approx(52.0)
  bound = field_bounds.decode_bound((1361, 2048), (680, 1024), 128, 512)
  assert bound["bound_by"] == "operations"
  assert bound["ops"] == pytest.approx(3 * 2 * 1024 * 680 * 128 * 512, rel=0.01)
  want = [100.0 * bound["ms"] / 6.0, 100.0 * bound["ms"] / 8.0]
  assert read["field_decode_roofline.field"](ctx) == pytest.approx(sum(want) / 2)
  # a port without the decoder's spans, or without device times: nothing
  before = [r for r in RECORDS if not r["name"].startswith("tgr.field")]
  monkeypatch.setattr(tracing, "records", lambda: before)
  assert read["field_decode_span_ms.field"](ctx) is None
  assert read["field_decode_roofline.field"](ctx) is None
  monkeypatch.setattr(tracing, "records", lambda: [dict(r, device_ms=None) for r in RECORDS])
  assert all(r(ctx) is None for r in read.values())


def test_control_fails_the_limits():
  cell = small_field_cell(channels=20)
  dev = runner.Device("cpu")
  entry = runner.make_entry(cell, 2**41 + 5, dev)
  entry.setup()
  entry.free()
  ref = entry.reference_readings()
  checks = harness.judge(entry.compare(entry.reference_readings(tf32=True), ref),
                         cell.limits)
  assert not harness.all_within(checks), checks
  sound = harness.judge(entry.compare(entry.reference_readings(), ref), cell.limits)
  assert harness.all_within(sound), sound


def test_a_port_without_point_features_stops_at_set_up(monkeypatch):
  original = tgr.render_gaussians

  def render_gaussians(gaussians, camera_params, config=tgr.RasterConfig(),
                       use_sh=False, render_depth=False):
    return original(gaussians, camera_params, config, use_sh, render_depth)

  monkeypatch.setattr(tgr, "render_gaussians", render_gaussians)
  entry = runner.make_entry(small_field_cell(), 5, runner.Device("cpu"))
  t0 = time.perf_counter()
  with pytest.raises(RuntimeError, match="point_features"):
    entry.setup()
  assert time.perf_counter() - t0 < 5.0


@pytest.fixture
def restore(monkeypatch):
  """Put the port and torch's Adam back as they were after a fault planted
  in this process."""
  monkeypatch.setattr(renderer, "rasterize_with_tiles", renderer.rasterize_with_tiles)
  monkeypatch.setattr(ParameterClass, "step", ParameterClass.step)
  monkeypatch.setattr(ParameterClass, "create", ParameterClass.create)
  monkeypatch.setattr(torch.optim, "Adam", torch.optim.Adam)


FAULTS = [None, faults.state_unchanged, faults.half_batch, faults.lr_off,
          field_faults.semantic_lr_off, field_faults.decoder_lr_off]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__ if f else "sound" for f in FAULTS])
def test_fault_is_caught(restore, fault):
  correct, numbers, _ = small.run(small_field_cell(channels=20), hook=fault)
  assert correct == (fault is None), numbers


def test_decoder_leaves_are_held_by_their_own_norm():
  """At the cell's size the decoder's W and b change hundreds of times
  less than the median leaf: over its norm, a decoder stepped at 1.1 times
  its rate reads 4e-4 and passes; over their own, 0.1."""
  field_train = harness.load_part("entries", "field_train")
  gen = torch.Generator().manual_seed(4)
  shapes = {"position": (4000, 3), "log_scaling": (4000, 3), "rotation": (4000, 4),
            "alpha_logit": (4000, 1), "feature": (4000, 48),
            "semantic_feature": (4000, 128), "decoder_weight": (512, 128),
            "decoder_bias": (512,)}
  scale = {"decoder_weight": 3e-5, "decoder_bias": 3e-5}
  init = {k: torch.randn(s, generator=gen, dtype=torch.float64) for k, s in shapes.items()}
  step = {k: torch.randn(s, generator=gen, dtype=torch.float64) * scale.get(k, 1e-2)
          for k, s in shapes.items()}
  g1 = {k: torch.randn(s, generator=gen, dtype=torch.float64) for k, s in shapes.items()}
  ref = dict(losses=[1.0], init=init, g1=g1, after={k: init[k] + step[k] for k in init})
  for k in field_train.DECODER:
    after = dict(ref["after"], **{k: init[k] + 1.1 * step[k]})
    prog = dict(losses=[1.0], g1=g1, after=after)
    assert field_train.train.train_numbers(prog, ref)["change_gap"] < 1e-3
    numbers = field_train.FieldTrain.compare(None, prog, ref)
    assert numbers["change_gap"] == pytest.approx(0.1, rel=1e-6)
    assert numbers["grad_gap"] == 0.0
    grad = dict(g1, **{k: g1[k] * 1.01})
    numbers = field_train.FieldTrain.compare(None, dict(prog, after=ref["after"], g1=grad),
                                             ref)
    assert numbers["grad_gap"] == pytest.approx(0.01, rel=1e-6)
    assert numbers["change_gap"] == 0.0
