"""Cells of BENCHMARK.json at a size a CPU test run can hold: the same
recipes, traffic and limits, with fewer points, a smaller image and fewer
views; `field=True` makes the configuration a feature field (raw
channels and the rendered depth, the mse_depth loss), the path of the
port that no committed cell drives yet."""

import copy
import time

from splatbench import harness, runner


def small_cell(name: str, root=harness.ROOT, ranks: int = 2,
               field: bool = False) -> harness.Cell:
  bench = harness.load_benchmark(root)
  cfg = copy.deepcopy(harness.Cell(bench, name, root).config)
  cfg["scene"]["points"] = 3000
  cfg["image_size"] = [120, 90]
  if field:
    cfg.update(scene={"recipe": "random", "points": 3000},
               features={"kind": "raw", "channels": 5}, render_depth=True,
               loss="mse_depth")
  cell = harness.Cell(bench, name, root, config=cfg)
  cell.traffic = dict(cell.traffic, views=8, check_within=6, trace_skip=2,
                      trace_frames=3, trace_steps=3)
  if cell.traffic["entry"] == "dp_train":
    cell.traffic["ranks"] = ranks
  return cell


def run(cell, seed: int = 2**40 + 17, trace: bool = False, hook=None):
  """(correct, numbers) of one run of the cell on the CPU, with a window
  of 0.5 s, judged by the cell's own limits."""
  if cell.traffic["entry"] == "dp_train":
    ranks = runner.run_dp(cell, seed, 0.5, trace, "cpu", hook)
  else:
    if hook is not None:
      hook()
    ranks = [runner.run_cell(cell, seed, 0.5, trace, "cpu", 0, time.time())]
  numbers = harness.worst([r["numbers"] for r in ranks])
  checks = harness.judge(numbers, cell.limits)
  return harness.all_within(checks), numbers, ranks
