#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from
(`splatbench/limits/<cell>.json`, PERF.md §2), for one cell:

    python3 splatbench/readings.py --workload <cell> --seeds <n> [<n> ...]
        [--control K] [--faults K] [--seconds S] [--plant FAULT] [--out FILE]

For each seed, the cell's own set-up and a short window of S seconds,
then the numbers the run compares, program against reference (`program`
rows: the lower readings). For the first K seeds also the control, the
reference computed in TF32 put in the program's place (`control` rows),
and for training cells with --faults the reference with half of the batch
left out, the mean taken over the rest (`half_batch` rows). With --plant,
a fault of `splatbench/tests/faults.py` is planted in the program under
every run, whose rows are then `fault:<name>`. A state left
unchanged reads 1 on `change_gap` by definition and needs no run. One
JSON line a row; the benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

from splatbench import harness  # noqa: E402


def collect(cell, seeds, control: int, faults: int, seconds: float,
            kind: str, device, rank: int = 0):
  """The rows for every seed, on this rank."""
  import torch
  from splatbench import runner
  dev = runner.Device(device)
  rows = []
  for i, seed in enumerate(seeds):
    t0 = time.perf_counter()
    entry = runner.make_entry(cell, seed, dev, rank)
    entry.setup()
    entry.window(seconds, False)
    prog = entry.readings()
    entry.free()
    if dev.cuda:
      torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = entry.reference_readings()
    dev.sync()
    t2 = time.perf_counter()
    trains = getattr(entry, "trains", False)
    row = dict(seed=seed, kind=kind, numbers=entry.compare(prog, ref),
               setup_and_window_s=t1 - t0, reference_s=t2 - t1)
    rows.append(dict(row, **entry.detail(prog, ref)) if trains else row)
    if i < control:
      ctrl = entry.reference_readings(tf32=True)
      row = dict(seed=seed, kind="control", numbers=entry.compare(ctrl, ref))
      rows.append(dict(row, **entry.detail(ctrl, ref)) if trains else row)
      del ctrl
    if i < faults and trains:
      rows.append(dict(seed=seed, kind="half_batch",
                       numbers=entry.compare(entry.reference_readings(half=True), ref)))
    del entry, prog, ref
    if dev.cuda:
      torch.cuda.empty_cache()
  return rows


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seeds", type=int, nargs="+", required=True)
  p.add_argument("--control", type=int, default=0)
  p.add_argument("--faults", type=int, default=0)
  p.add_argument("--seconds", type=float, default=4.0)
  p.add_argument("--out", default=None)
  p.add_argument("--plant", default=None,
                 help="a fault of splatbench/tests/faults.py, planted in the "
                      "program under every seed's run (rows `fault:<name>`)")
  args = p.parse_args(argv)
  import torch
  from splatbench import runner
  cell = harness.Cell(harness.load_benchmark(ROOT), args.workload, ROOT)
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    harness.log(f"{cell.name} needs {cell.chips} CUDA device(s)")
    return 3
  harness.log(f"card: {harness.card_line()}")
  hook = None
  if args.plant:
    from splatbench.tests import faults
    hook = getattr(faults, args.plant)
  kind = f"fault:{args.plant}" if args.plant else "program"
  fn_args = (cell, args.seeds, args.control, args.faults, args.seconds, kind)
  if cell.traffic["ranks"] > 1:
    per_rank = runner.spawn_ranks(cell.traffic["ranks"], "cuda", collect, fn_args,
                                  hook)
    rows = per_rank[0]
    for i, row in enumerate(rows):
      row["numbers"] = harness.worst([r[i]["numbers"] for r in per_rank])
      row["ranks"] = [r[i]["numbers"] for r in per_rank]
  else:
    if hook is not None:
      hook()
    rows = collect(*fn_args, "cuda")
  out = open(args.out, "a") if args.out else None
  for row in rows:
    line = json.dumps(dict(row, cell=cell.name))
    print(line, flush=True)
    if out:
      out.write(line + "\n")
  if out:
    out.close()
  return 0


if __name__ == "__main__":
  sys.exit(main())
