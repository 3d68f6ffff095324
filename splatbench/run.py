#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port
(`taichi_gaussian_rasterizer_tpu_torch`) once, from the root of a checkout:

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a `workloads` entry of BENCHMARK.json. The run loads the
port's CUDA kernels (built by nvcc into the checkout's `build/kernels/` on
the first run of a checkout, found there after), makes the cell's scene,
cameras and targets on the card from --seed, warms the traffic's own
shapes, and measures for --seconds. With --trace 0 it prints the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (a short
sub-window under torch.profiler, the per-layer readers of
`splatbench/metrics/`). Either way it then holds what the timed path
produced against the plain reference (`splatbench/reference.py`) and prints
each compared number beside its limit (`splatbench/limits/<cell>.json`) as
the last lines of stderr, then one JSON line as the last line of stdout.

It exits non-zero and prints no result when no card or too few cards are
visible, when the port is not beside it, or when any module of JAX, of
the JAX package (`taichi_gaussian_rasterizer_tpu`) or of its TPU
benchmark (`bench`, `benchmarks`) is loaded, at the start or once the
window has closed (top-level module names compared whole).

Disk and paths: a run writes only the kernel build under the checkout's
`build/` (a few MB, once a checkout) and whatever nvcc puts in TMPDIR. No
trace file is written; profiles are read in memory. Nothing goes to
/dev/shm (the four-card cell sets NCCL_SHM_DISABLE=1) and no fixed path
under /tmp is used; the four-card cell's ranks meet on a TCP store on
localhost at a free port.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
  os.environ.setdefault(var, str(ROOT / "build" / sub))

from splatbench import harness  # noqa: E402


def parse(argv):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def run_dp(cell, seed, seconds, trace) -> list:
  """The cell's ranks, one process a card (`runner.run_dp`), after the
  kernels are compiled here, with no CUDA context: the ranks then only
  load them."""
  from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (backward,
                                                               forward, reduce)
  from taichi_gaussian_rasterizer_tpu_torch.utils import cuda_build
  from splatbench import runner
  for k in (forward.RASTER_FORWARD, backward.RASTER_BACKWARD, reduce.SEGMENT_SUM):
    cuda_build.build(k.source)
  return runner.run_dp(cell, seed, seconds, trace, "cuda")


def result_line(cell, ranks, trace, dev_info):
  """The contract's result (without its checks) from every rank's
  pieces."""
  head = ranks[0]
  setup_s = (head["window_start"] - T0) if head.get("window_start") else head["setup_s"]
  e2e = dict(head["e2e"], setup_s=setup_s,
             peak_gib=max(r["window_peak"] for r in ranks) / 2**30)
  metrics = {}
  if trace:
    metrics = head.get("layers", {})
  else:
    for m in cell.end_to_end:
      metrics[m["name"]] = {"value": e2e[cell.measure(m["name"])], "unit": m["unit"]}
  device = dict(dev_info, memory_peak_bytes=max(r["memory_peak_bytes"] for r in ranks))
  out = dict(attempted=e2e["attempted"], metrics=metrics, device=device)
  profiles = [r.get("profile") for r in ranks]
  if trace and all(profiles):
    device["busy_s"] = sum(p["busy_s"] for p in profiles) / len(profiles)
    device["window_s"] = profiles[0]["window_s"]
    out["breakdown"] = {"device_ops": profiles[0]["device_ops"],
                        "idle_gaps": profiles[0]["idle_gaps"]}
  return out


def main(argv=None) -> int:
  args = parse(argv)
  found = harness.forbidden_loaded(sys.modules)
  if found:
    harness.log(f"refused: forbidden modules loaded at start: {found}")
    return 2
  cell = harness.Cell(harness.load_benchmark(ROOT), args.workload, ROOT)
  if cell.limits is None:
    harness.log(f"no limits file for {cell.name}")
    return 2
  import torch
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    harness.log(f"refused: {cell.name} needs {cell.chips} CUDA device(s), "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return 3
  harness.log(f"card: {harness.card_line()}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
  try:
    if cell.traffic["ranks"] > 1:
      ranks = run_dp(cell, args.seed, args.seconds, bool(args.trace))
    else:
      from splatbench import runner
      ranks = [runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                "cuda", 0, T0)]
  except Exception:
    harness.log(traceback.format_exc())
    return 1
  found = harness.forbidden_loaded(sys.modules)
  if found:
    harness.log(f"refused: forbidden modules loaded once the window closed: {found}")
    return 4
  numbers = harness.worst([r["numbers"] for r in ranks])
  harness.log(f"numbers: {numbers}")
  checks = harness.judge(numbers, cell.limits)
  dev_info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell.chips)
  out = result_line(cell, ranks, bool(args.trace), dev_info)
  failed = sum(not harness.all_within({k: c}) for k, c in checks.items())
  result = dict(correct=failed == 0, attempted=out["attempted"], failed=failed,
                metrics=out["metrics"], device=out["device"])
  if "breakdown" in out:
    result["breakdown"] = out["breakdown"]
  harness.print_result(result, checks)
  return 0


if __name__ == "__main__":
  sys.exit(main())
