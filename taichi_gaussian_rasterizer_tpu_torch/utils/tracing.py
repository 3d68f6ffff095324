"""Spans and counts at the port's layer boundaries, recorded only while a
`torch.profiler` profile is active.

With no profile active `span` returns one shared no-op context: no
`record_function` is entered, no CUDA event is made, no autograd hook is
registered and nothing is appended. The test is a read of the flag that
`torch.profiler` sets, so a loop that is not profiled pays a function
call a span. Under a profile each span

* enters `record_function("tgr.<name>")`, so that it lies on the trace's
  own clock around the kernels it launches, and
* appends a record to a bounded in-memory buffer (`records`, `clear`):
  its name, its id and its parent's, the frame id shared by every span of
  one frame (a span with no parent opens a frame: `render_gaussians`'
  `tgr.render`, whose backward spans take the forward's frame), the host
  clock at its start and end (`perf_counter_ns`), a pair of CUDA events on
  the current stream where the process uses CUDA, and its counts.

Nothing is read from the device inside a span: the events' elapsed time
and counts held in device tensors are resolved by `records()`, which the
caller reaches after its own synchronize.

Spans of the port, and the counts they carry:

  tgr.render        render_gaussians (frame root)
  tgr.project       project_to_image
  tgr.sh            evaluate_sh_at: points (rows shaded), kernel_points
                    (rows the CUDA kernel shaded, 0 on the plain path)
  tgr.sh.bwd        the SH kernel's autograd backward (CUDA tensors only;
                    parent and frame from the forward's tgr.sh)
  tgr.map           map_to_tiles: candidates (keys sorted), overlaps (kept)
  tgr.map.sync      its one host sync, the candidate total
  tgr.raster.fwd    the blend's autograd forward: channels (F blended)
  tgr.raster.bwd    the blend's autograd backward
  tgr.reduce.sort   the gradient reduction's stable sort: rows (R), chunks
                    (1), kernel_rows (the rows the CUDA kernel reduced from
                    slot-major storage without a repack, 0 on the plain
                    path); then one more span around the gather and sums
  tgr.project.bwd   from the end of tgr.raster.bwd to the last gradient
                    hook on the frame's Gaussians3D tensors (`tail`)
  tgr.optim.step    ParameterClass.step: elements (N * D over the groups
                    stepped), kernel_elements (those the CUDA kernel
                    stepped, 0 on the plain path)
  tgr.field.decode  the feature decoder's resize and 1x1 convolution
                    (models.feature_decoder): pixels (out), in_channels,
                    out_channels
  tgr.field.decode.bwd  its autograd backward (parent the forward's span),
                    with the same counts
  tgr.dp.pack       the flat all-reduce's cat, casts and split, around
  tgr.dp.allreduce  its one dist.all_reduce
"""

import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "tgr."
CAPACITY = 65536

_records = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
  stack = getattr(_local, "stack", None)
  if stack is None:
    stack = _local.stack = []
  return stack


class _Off:
  """The shared no-op span of a process that is not profiled."""

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False

  def count(self, **counts) -> None:
    pass


_OFF = _Off()


class _Record:
  """One finished span, as the buffer holds it."""

  __slots__ = ("name", "id", "parent", "frame", "start_ns", "end_ns",
               "events", "device_ms", "counts")

  def resolve(self) -> Dict:
    if self.events is not None:
      start, end = self.events
      self.device_ms = start.elapsed_time(end)
      self.events = None
    self.counts = {k: v.item() if isinstance(v, torch.Tensor) else v
                   for k, v in self.counts.items()}
    return dict(name=self.name, id=self.id, parent=self.parent,
                frame=self.frame, start_ns=self.start_ns, end_ns=self.end_ns,
                host_ms=(self.end_ns - self.start_ns) * 1e-6,
                device_ms=self.device_ms, counts=dict(self.counts))


class _Span:
  """A span while spans record. `parent` (a span of the forward, for a
  backward span on autograd's thread) overrides this thread's innermost
  open span. `watch`, on a frame root, is the dataclass of tensors whose
  gradient hooks close the frame's `tail`."""

  def __init__(self, name: str, parent: Optional["_Span"] = None, watch=None):
    self.name = PREFIX + name
    self.parent = parent
    self.watch = watch
    self.counts: Dict = {}

  def open(self, push: bool) -> "_Span":
    stack = _stack()
    parent = self.parent if self.parent is not None else (stack[-1] if stack else None)
    self.id = next(_ids)
    self.parent_id = None if parent is None else parent.id
    self.frame = self.id if parent is None else parent.frame
    self._rf = torch.autograd.profiler.record_function(self.name)
    self._rf.__enter__()
    self.events = None
    if torch.cuda.is_initialized():
      self.events = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
      self.events[0].record()
    self.pushed = push
    if push:
      stack.append(self)
    self.start_ns = time.perf_counter_ns()
    return self

  def close(self) -> None:
    end_ns = time.perf_counter_ns()
    if self.events is not None:
      self.events[1].record()
    if self.pushed:
      _stack().remove(self)
    self._rf.__exit__(None, None, None)
    r = _Record()
    r.name, r.id, r.parent, r.frame = self.name, self.id, self.parent_id, self.frame
    r.start_ns, r.end_ns, r.events, r.device_ms = self.start_ns, end_ns, self.events, None
    r.counts = self.counts
    _records.append(r)

  def __enter__(self) -> "_Span":
    return self.open(push=True)

  def __exit__(self, *exc):
    self.close()
    return False

  def count(self, **counts) -> None:
    """Attach counts: ints, or device scalars, which `records()` reads; a
    device scalar is copied, so that a view keeps no larger tensor alive."""
    self.counts.update({k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in counts.items()})


def span(name: str, parent=None, watch=None):
  """A span named `tgr.<name>`: a context, with `count(**counts)`. With no
  profile active, one shared no-op context."""
  if not _profiler._is_profiler_enabled:
    return _OFF
  return _Span(name, parent, watch)


def current():
  """This thread's innermost open span (a forward captures it for its
  backward spans), or None."""
  if not _profiler._is_profiler_enabled:
    return None
  stack = _stack()
  return stack[-1] if stack else None


def tail(name: str, parent) -> None:
  """Open span `name` under `parent`, a frame root with `watch`, at the
  end of the frame's backward node, and register a hook on each watched
  tensor that requires grad: the last hook to fire closes the span and
  removes the hooks. If some hook does not fire (a gradient taken for
  part of the tensors), the end of the backward pass closes it. Call from
  inside an autograd backward."""
  if parent is None or parent.watch is None or not _profiler._is_profiler_enabled:
    return
  tensors = [t for t in (getattr(parent.watch, f.name)
                         for f in dataclasses.fields(parent.watch))
             if isinstance(t, torch.Tensor) and t.requires_grad]
  if not tensors:
    return
  s = _Span(name, parent).open(push=False)
  left = [len(tensors)]
  handles = []

  def close():
    if handles:
      for h in handles:
        h.remove()
      handles.clear()
      s.close()

  def hook(grad):
    left[0] -= 1
    if left[0] == 0:
      close()

  handles.extend(t.register_hook(hook) for t in tensors)
  torch.autograd.Variable._execution_engine.queue_callback(close)


def records() -> List[Dict]:
  """Every buffered record, oldest first, as dicts: name, id, parent,
  frame, start_ns, end_ns, host_ms, device_ms (None without CUDA
  events) and counts. Resolves the CUDA events and device counts, so
  call it after synchronising the device."""
  return [r.resolve() for r in list(_records)]


def clear() -> None:
  """Empty the buffer."""
  _records.clear()
