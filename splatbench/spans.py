"""Reading the port's own spans (`taichi_gaussian_rasterizer_tpu_torch.
utils.tracing`) for the per-layer metrics that read them.

The port records spans only while a `torch.profiler` profile is active,
and a run profiles only its traced sub-window, so the port's buffer holds
that sub-window's records alone. A frame is one `render_gaussians` call
with its backward (the spans share its frame id); a span outside any
frame, such as `tgr.optim.step` or `tgr.dp.pack`, opens its own, one a
step. Each reader takes the median over the frames (or steps) of a
per-frame sum, on the rank that reads (rank 0). Every function here
returns None when the records hold no device times (on the CPU), and when
the port has no tracing module (before it had one).
"""

import statistics
from collections import defaultdict
from typing import Callable, Dict, List, Optional


def records() -> Optional[List[Dict]]:
  """The port's records of the traced sub-window, or None where they hold
  no device times or the port records none."""
  try:
    from taichi_gaussian_rasterizer_tpu_torch.utils import tracing
  except ImportError:
    return None
  recs = tracing.records()
  if not any(r["device_ms"] is not None for r in recs):
    return None
  return recs


def per_frame(recs: List[Dict], names, value: Callable[[Dict], float]) -> Dict:
  """{frame id: the sum of value(record) over its records named in
  `names` (without the `tgr.` prefix)}."""
  names = {"tgr." + n for n in names}
  sums = defaultdict(float)
  for r in recs:
    if r["name"] in names:
      sums[r["frame"]] += value(r)
  return sums


def median_ms(*names: str, field: str = "device_ms") -> Optional[float]:
  """The median over frames of the per-frame sum of the spans' `field`
  (device_ms, or host_ms)."""
  recs = records()
  if recs is None:
    return None
  sums = per_frame(recs, names, lambda r: r[field])
  return statistics.median(sums.values()) if sums else None


def self_ms(name: str, child: str) -> Optional[float]:
  """The median over frames of span `name`'s device ms less those of its
  `child` spans (its self time)."""
  recs = records()
  if recs is None:
    return None
  total = per_frame(recs, [name], lambda r: r["device_ms"])
  inner = per_frame(recs, [child], lambda r: r["device_ms"])
  return statistics.median(total[f] - inner[f] for f in total) if total else None


def count_ratio(name: str, part: str, whole: str) -> Optional[float]:
  """The median over frames of 100 · (the sum of count `part`) / (the sum
  of count `whole`) of span `name`."""
  recs = records()
  if recs is None:
    return None
  parts = per_frame(recs, [name], lambda r: r["counts"][part])
  wholes = per_frame(recs, [name], lambda r: r["counts"][whole])
  shares = [100.0 * parts[f] / wholes[f] for f in wholes if wholes[f] > 0]
  return statistics.median(shares) if shares else None
