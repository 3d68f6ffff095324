"""Debug and profiling switches (port of
`taichi_gaussian_rasterizer_tpu.utils.runtime`).

`debug_mode` is the reference's debug-arch role: autograd anomaly
detection, and every CUDA kernel wrapper synchronises after its launch
so that a fault inside a kernel raises at that launch. It never swaps
the plain version in for a kernel. `check_finite` is the debugging
helper; the port's spans are `utils.tracing`.

Left out: `init` and `host_fingerprint`, which configure JAX's platform
and its XLA compile cache; PyTorch has neither to configure.
"""

import contextlib
import dataclasses

import torch

from . import cuda_build


@contextlib.contextmanager
def debug_mode():
  """Anomaly detection on, and each kernel launch synchronised and
  checked, inside the block; both restored after it."""
  prev_anomaly = torch.is_anomaly_enabled()
  prev_sync = cuda_build.SYNC_AFTER_LAUNCH
  torch.autograd.set_detect_anomaly(True)
  cuda_build.SYNC_AFTER_LAUNCH = True
  try:
    yield
  finally:
    torch.autograd.set_detect_anomaly(prev_anomaly)
    cuda_build.SYNC_AFTER_LAUNCH = prev_sync


def _leaves(tree, path="tree"):
  """(path, leaf) pairs of nested dicts, lists, tuples and dataclasses."""
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaves(v, f"{path}[{k!r}]")
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      yield from _leaves(v, f"{path}[{i}]")
  else:
    yield path, tree


def check_finite(tree, name: str = "tree"):
  """Raise ValueError naming every floating tensor of the tree that holds
  a NaN or an infinity, with its count. Synchronises with the device: for
  debugging."""
  bad = {}
  for path, leaf in _leaves(tree, name):
    if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
      n = int((~torch.isfinite(leaf)).sum())
      if n:
        bad[path] = n
  if bad:
    raise ValueError(f"non-finite values in {name}: {bad}")
