"""Reading a `torch.profiler` trace of a short steady sub-window.

The traced sub-window is wrapped in `record_function(WINDOW)`; its CPU
event gives the window's bounds on the trace's clock. Device time is the
union of the CUDA-side events (kernels, memcpy, memset) clipped to it;
idle gaps are the holes in that union, each named by the innermost host
operation running at its middle. Nothing is written to disk.
"""

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "splatbench.window"
# events that are no device work and no host operation: the window's own
# annotation (which the trace repeats on the device's timeline) and the
# profiler's buffer bookkeeping
IGNORED = frozenset({WINDOW, "Activity Buffer Request"})


def profiler():
  acts = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  return torch.profiler.profile(activities=acts)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1] = (out[-1][0], max(out[-1][1], e))
    else:
      out.append((s, e))
  return out


def _host_op_at(host, starts, time: float, scan: int = 20000) -> str:
  """The innermost host event (latest start) that spans `time`."""
  i = bisect.bisect_right(starts, time) - 1
  for j in range(i, max(i - scan, -1), -1):
    if host[j][1] >= time:
      return host[j][2]
  return "(no host op)"


def summarize(prof, steps: int) -> Optional[Dict]:
  """dict(window_s, busy_s, device_ops [[name, s]] top 10, idle_gaps
  [[host op, s]] top 10, nccl_ms_per_step) of the traced sub-window, or
  None when the trace holds no window or no device event."""
  events = list(prof.events())
  window = [e for e in events if e.name == WINDOW
            and getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA]
  if not window:
    return None
  ws, we = window[0].time_range.start, window[0].time_range.end
  device, host = [], []
  for e in events:
    s, t = e.time_range.start, e.time_range.end
    if e.name in IGNORED or getattr(e, "is_user_annotation", False):
      continue
    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
      s, t = max(s, ws), min(t, we)
      if t > s:
        device.append((s, t, e.name))
    elif t > s:
      host.append((s, t, e.name))
  if not device:
    return None
  busy = _union([(s, t) for s, t, _ in device])
  busy_us = sum(t - s for s, t in busy)
  by_op = defaultdict(float)
  nccl_us = 0.0
  for s, t, name in device:
    by_op[name] += t - s
    if "nccl" in name.lower():
      nccl_us += t - s
  gaps = []
  edge = ws
  for s, t in busy:
    if s > edge:
      gaps.append((edge, s))
    edge = max(edge, t)
  if we > edge:
    gaps.append((edge, we))
  host.sort()
  starts = [h[0] for h in host]
  by_host = defaultdict(float)
  for s, t in gaps:
    by_host[_host_op_at(host, starts, 0.5 * (s + t))] += t - s
  def top(d):   # names cut to 120 characters: a kernel's template
               # arguments can run to a thousand
    return [[k[:120], v * 1e-6] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:10]]
  return dict(window_s=(we - ws) * 1e-6, busy_s=busy_us * 1e-6,
              device_ops=top(by_op), idle_gaps=top(by_host),
              nccl_ms_per_step=nccl_us * 1e-3 / max(steps, 1),
              steps=steps)
