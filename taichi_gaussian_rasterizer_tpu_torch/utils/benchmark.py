"""Timing harness (port of `taichi_gaussian_rasterizer_tpu.utils.benchmark`)."""

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch

from .runtime import _leaves, profiler_trace


def _on_card(result) -> bool:
  return any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
             for _, leaf in _leaves(result))


def benchmarked(name: str, fn: Callable, *args, iters: int = 50,
                warmup: int = 3, profile: bool = False, **kwargs):
  """Time fn(*args, **kwargs) after `warmup` calls; returns (result,
  ms a call). A result on the card is timed by CUDA events around the
  iterations, any other by the host clock. With `profile` the timed
  iterations are traced (`runtime.profiler_trace`) into
  <temp dir>/tgr_trace_<name>."""
  result = None
  for _ in range(max(warmup, 1)):
    result = fn(*args, **kwargs)
  card = _on_card(result)
  trace = (profiler_trace(os.path.join(tempfile.gettempdir(), f"tgr_trace_{name}"))
           if profile else contextlib.nullcontext())
  with trace:
    if card:
      torch.cuda.synchronize()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(iters):
        result = fn(*args, **kwargs)
      end.record()
      torch.cuda.synchronize()
      ms = start.elapsed_time(end) / iters
    else:
      t0 = time.perf_counter()
      for _ in range(iters):
        result = fn(*args, **kwargs)
      ms = (time.perf_counter() - t0) / iters * 1e3
  print(f"{name}: {ms:.3f} ms/call ({1000.0 / ms:.1f} it/s, "
        f"{'CUDA events' if card else 'host clock'})")
  return result, ms
