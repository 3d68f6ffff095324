"""What every cell shares: finding a cell's files by name, the import
check, the card's description and the result line.

A cell is one entry of `workloads` in `BENCHMARK.json`. Its configuration
is the JSON file the `configs` entry names; its traffic mix is
`splatbench/traffic/<traffic>.json`, which names the entry its window
drives (`splatbench/entries/<entry>.py`) and which of the window's
measures each end-to-end metric reports; the configuration's scene recipe
is `splatbench/recipes/<recipe>.py` and its loss
`splatbench/losses/<loss>.py`; its limits are
`splatbench/limits/<cell>.json`; each per-layer metric is read by
`splatbench/metrics/<metric>.py`, a module with `read(ctx)` that returns a
number or None when it finds nothing to read. A later cell, mix, entry,
recipe, loss or metric is added with new files and a `workloads` entry:
nothing here changes.
"""

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that nothing run on the card may load: JAX, and
# the JAX package with its TPU benchmark (compared as whole names, so that
# the port, `taichi_gaussian_rasterizer_tpu_torch`, passes)
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax",
                               "taichi_gaussian_rasterizer_tpu",
                               "bench", "benchmarks"})


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
  """The names in `modules` whose top-level name is forbidden."""
  return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_benchmark(root: Path = ROOT) -> Dict:
  with open(root / "BENCHMARK.json") as f:
    return json.load(f)


class Cell:
  """One workload of BENCHMARK.json with its configuration, traffic,
  limits and metrics."""

  def __init__(self, bench: Dict, name: str, root: Path = ROOT,
               config: Optional[Dict] = None):
    """`config` stands in for the configuration's file (tests run a cell
    at a small size on the CPU)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
      raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                     f"have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    self.name = name
    self.chips = int(w["chips"])
    if config is None:
      with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    self.config = config
    with open(root / "splatbench" / "traffic" / f"{w['traffic']}.json") as f:
      self.traffic = json.load(f)
    limits = root / "splatbench" / "limits" / f"{name}.json"
    self.limits = json.loads(limits.read_text()) if limits.exists() else None
    self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in self.end_to_end}
    self.per_layer = [m for m in bench["per_layer"]
                      if _reports(m, name) and m["moves"] in e2e_names]
    self.root = root

  def measure(self, metric: str) -> str:
    """Which of the window's measures end-to-end metric `metric` reports:
    the traffic's `measures` say it; `setup_s` is every run's set-up."""
    if metric == "setup_s":
      return "setup_s"
    measures = self.traffic.get("measures", {})
    if metric not in measures:
      raise KeyError(f"traffic of {self.name} names no measure for {metric!r}")
    return measures[metric]


def _reports(metric: Dict, cell: str) -> bool:
  return "workloads" not in metric or cell in metric["workloads"]


_PARTS: Dict[Path, ModuleType] = {}


def load_part(kind: str, name: str, root: Path = ROOT) -> ModuleType:
  """The module splatbench/<kind>/<name>.py (an entry, a recipe, a loss or
  a metric's reader), loaded once a process."""
  path = (root / "splatbench" / kind / f"{name}.py").resolve()
  if path not in _PARTS:
    if not path.is_file():
      raise KeyError(f"no {kind} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"splatbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _PARTS[path] = module
  return _PARTS[path]


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
  """The reader of per-layer metric `name`: splatbench/metrics/<name>.py."""
  return load_part("metrics", name, root)


def card_line() -> str:
  """The card's name and power limit as nvidia-smi reads them."""
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return "; ".join(out.stdout.strip().splitlines()) or "nvidia-smi: no output"
  except (OSError, subprocess.SubprocessError) as e:
    return f"nvidia-smi unavailable ({e})"


def quantile(values: List[float], q: float) -> float:
  """The nearest-rank q-quantile (0 < q <= 1) of values."""
  s = sorted(values)
  return s[max(0, math.ceil(q * len(s)) - 1)]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
  """{name: {value, limit}} for every limited number; a number that is
  NaN or missing fails."""
  out = {}
  for name, limit in limits.items():
    v = numbers.get(name, math.nan)
    out[name] = {"value": v, "limit": limit}
  return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
  """Each number's worst (largest, or NaN) reading over several ranks."""
  out = {}
  for r in readings:
    for k, v in r.items():
      old = out.get(k, v)
      out[k] = v if math.isnan(v) or math.isnan(old) else max(old, v)
  return out


def all_within(checks: Dict) -> bool:
  return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())


def print_result(result: Dict, checks: Dict) -> None:
  """The compared numbers beside their limits as the last lines of
  stderr, then the result as the last line of stdout, with the checks as
  its last key."""
  def num(v):
    return v if math.isfinite(v) else str(v)
  for name, c in checks.items():
    print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
  sys.stderr.flush()
  line = dict(result, checks={k: {"value": num(c["value"]), "limit": c["limit"]}
                              for k, c in checks.items()})
  print(json.dumps(line), flush=True)


def log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)
