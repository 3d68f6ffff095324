"""A new configuration, scene recipe, loss, entry, traffic mix, end-to-end
metric and per-layer metric are found by name: added as files (and
`configs` / `workloads` / `end_to_end` / `per_layer` entries) in a copy
of the benchmark, with no edit to any file that is there."""

import hashlib
import json
import shutil
import time

from splatbench import harness, runner

# a new entry: `serve`, whose window also measures the median frame time
NEW_ENTRY = '''
from pathlib import Path

from splatbench import harness

Serve = harness.load_part("entries", "serve", Path(__file__).resolve().parents[2]).Serve


class ServeMedian(Serve):

  def window(self, seconds, trace):
    out = super().window(seconds, trace)
    return dict(out, p50_ms=harness.quantile(self.frame_ms, 0.5))


ENTRY = ServeMedian
'''

# a new recipe: half of the points in a thin slab, half spread
NEW_RECIPE = '''
import torch

from splatbench import scenes


def make(generator, points, camera):
  g = scenes.random_3d_gaussians(generator, points, camera)
  g["position"][: points // 2, 2] *= 0.1
  return g
'''

# a new loss
NEW_LOSS = '''
import torch

EXTRA_CHANNELS = 0


def loss(image, depth, target):
  return torch.nn.functional.smooth_l1_loss(image, target)
'''


def _digests(root):
  return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
          for p in sorted((root / "splatbench").rglob("*"))
          if p.is_file() and "__pycache__" not in p.parts}


def test_new_parts_are_found_by_name(tmp_path):
  root = harness.ROOT
  shutil.copytree(root / "splatbench", tmp_path / "splatbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  before = _digests(tmp_path)
  bench = harness.load_benchmark(root)

  sb = tmp_path / "splatbench"
  cfg = json.loads((sb / "configs" / "bicycle6m.json").read_text())
  cfg.update(name="tinyfield", scene={"recipe": "slab", "points": 1500},
             image_size=[64, 48], features={"kind": "raw", "channels": 2},
             render_depth=True, loss="smooth_l1")
  (sb / "configs" / "tinyfield.json").write_text(json.dumps(cfg))
  (sb / "recipes" / "slab.py").write_text(NEW_RECIPE)
  (sb / "losses" / "smooth_l1.py").write_text(NEW_LOSS)
  (sb / "entries" / "serve_median.py").write_text(NEW_ENTRY)
  mix = json.loads((sb / "traffic" / "serve.json").read_text())
  mix.update(entry="serve_median", views=4, check_within=4, trace_skip=1,
             trace_frames=2, measures=dict(mix["measures"], render_p50_ms="p50_ms"))
  (sb / "traffic" / "serve-median.json").write_text(json.dumps(mix))
  train = json.loads((sb / "traffic" / "train.json").read_text())
  train.update(views=4, targets=2, warm_steps=3, trace_skip=1, trace_steps=2)
  (sb / "traffic" / "train-few.json").write_text(json.dumps(train))
  (sb / "limits" / "tinyfield.serve-median.json").write_text('{"frame_err": 1e-5}')
  (sb / "limits" / "tinyfield.train-few.json").write_text(
      '{"loss_gap_first": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3}')
  (sb / "metrics" / "slots.serve.py").write_text(
      "def read(ctx):\n  return float(ctx.work['n_slots'])\n")
  bench["configs"].append({"name": "tinyfield", "source": "test",
                           "file": "splatbench/configs/tinyfield.json",
                           "reduced": [], "why": "test"})
  for mix_name in ("serve-median", "train-few"):
    bench["workloads"].append({"name": f"tinyfield.{mix_name}", "config": "tinyfield",
                               "traffic": mix_name, "chips": 1, "why": "test"})
  bench["end_to_end"].append({"name": "render_p50_ms", "unit": "ms", "better": "lower",
                              "bound": 0.01, "source": "host_clock",
                              "workloads": ["tinyfield.serve-median"]})
  bench["per_layer"].append({"name": "slots.serve", "unit": "slots",
                             "better": "lower", "source": "program_counter",
                             "layer": "tile mapper", "moves": "render_ms",
                             "workloads": ["tinyfield.serve-median"]})
  grown = {"render_ms": "tinyfield.serve-median", "render_p95_ms": "tinyfield.serve-median",
           "train_step_ms": "tinyfield.train-few", "train_peak_gib": "tinyfield.train-few"}
  bench["end_to_end"] = [dict(m, workloads=m["workloads"] + [grown[m["name"]]])
                         if m["name"] in grown else m for m in bench["end_to_end"]]
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  new = harness.load_benchmark(tmp_path)

  cell = harness.Cell(new, "tinyfield.serve-median", tmp_path)
  assert cell.config["name"] == "tinyfield" and cell.traffic["views"] == 4
  assert cell.limits == {"frame_err": 1e-5}
  assert "slots.serve" in [m["name"] for m in cell.per_layer]
  assert [cell.measure(m["name"]) for m in cell.end_to_end] == [
      "mean_ms", "p95_ms", "setup_s", "p50_ms"]
  out = runner.run_cell(cell, 12345, 0.3, True, "cpu", 0, time.time())
  assert out["layers"]["slots.serve"]["value"] > 0
  assert out["e2e"]["p50_ms"] > 0
  assert out["numbers"]["frame_err"] < 1e-5

  cell = harness.Cell(new, "tinyfield.train-few", tmp_path)
  assert cell.measure("train_step_ms") == "step_ms"
  out = runner.run_cell(cell, 12345, 0.3, False, "cpu", 0, time.time())
  assert out["e2e"]["step_ms"] > 0
  assert harness.all_within(harness.judge(out["numbers"], cell.limits)), out["numbers"]

  after = _digests(tmp_path)
  assert {k: v for k, v in after.items() if k in before} == before
