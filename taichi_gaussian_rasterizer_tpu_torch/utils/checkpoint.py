"""Checkpoint and resume (port of
`taichi_gaussian_rasterizer_tpu.utils.checkpoint`).

`save_checkpoint` / `load_checkpoint` store a tree of nested dicts,
lists, tuples and dataclasses whose leaves are tensors, numpy arrays or
plain Python values (None, bool, int, float, str) -- for example a
`Gaussians3D`, or `ParameterClass.state_dict()` with its optimizer state
-- as one `torch.save` file that `torch.load(weights_only=True)` reads:
the tree's structure is kept beside the tensors as plain data, and a
dataclass by its importable name, so loading unpickles no code.

The JAX package's `save_orbax` / `load_orbax` use Orbax, a JAX library;
their counterparts here, `save_distributed` / `load_distributed`, use
`torch.distributed.checkpoint` (a directory of shards, ready for a
process group), which also runs in a single process without one.
"""

import contextlib
import dataclasses
import importlib
import json
import os
import warnings
from typing import Any, List

import numpy as np
import torch


def _encode(tree: Any, tensors: List[torch.Tensor]):
  """The tree's structure as plain data, its arrays appended to tensors."""
  if isinstance(tree, torch.Tensor):
    tensors.append(tree.detach().cpu())
    return {"tensor": len(tensors) - 1}
  if isinstance(tree, np.ndarray):
    tensors.append(torch.from_numpy(np.array(tree)))
    return {"ndarray": len(tensors) - 1}
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    cls = type(tree)
    return {"dataclass": f"{cls.__module__}:{cls.__qualname__}",
            "fields": {f.name: _encode(getattr(tree, f.name), tensors)
                       for f in dataclasses.fields(tree)}}
  if isinstance(tree, dict):
    return {"dict": [[k, _encode(v, tensors)] for k, v in tree.items()]}
  if isinstance(tree, (list, tuple)):
    return {type(tree).__name__: [_encode(v, tensors) for v in tree]}
  if tree is None or isinstance(tree, (bool, int, float, str)):
    return {"value": tree}
  raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _decode(spec, tensors, device):
  if "dataclass" in spec:
    module, name = spec["dataclass"].split(":")
    cls = importlib.import_module(module)
    for part in name.split("."):
      cls = getattr(cls, part)
    return cls(**{k: _decode(v, tensors, device)
                  for k, v in spec["fields"].items()})
  (kind, body), = spec.items()
  if kind == "tensor":
    return tensors[body].to(device)
  if kind == "ndarray":
    return tensors[body].numpy()
  if kind == "dict":
    return {k: _decode(v, tensors, device) for k, v in body}
  if kind == "list":
    return [_decode(v, tensors, device) for v in body]
  if kind == "tuple":
    return tuple(_decode(v, tensors, device) for v in body)
  return body


def save_checkpoint(path: str, tree: Any) -> None:
  """Save a tree of tensors and numpy arrays (module docstring)."""
  tensors: List[torch.Tensor] = []
  spec = _encode(tree, tensors)
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  torch.save({"spec": json.dumps(spec), "tensors": tensors}, path)


def load_checkpoint(path: str, device="cuda") -> Any:
  """Load a save_checkpoint tree, its tensors on `device` (the card
  unless the caller asks otherwise); numpy arrays stay numpy arrays."""
  payload = torch.load(path, map_location="cpu", weights_only=True)
  return _decode(json.loads(payload["spec"]), payload["tensors"], device)


@contextlib.contextmanager
def _single_process():
  """torch.distributed.checkpoint warns that it runs without a process
  group; in a single process that is the intent."""
  with warnings.catch_warnings():
    warnings.filterwarnings("ignore", message="torch.distributed is disabled")
    yield


def save_distributed(path: str, tree: Any) -> None:
  """Save a tree with `torch.distributed.checkpoint` into the directory
  `path`: each tensor is an entry, the structure one more."""
  import torch.distributed.checkpoint as dcp
  tensors: List[torch.Tensor] = []
  spec = _encode(tree, tensors)
  state = {"spec": json.dumps(spec)}
  state.update({f"t{i}": t for i, t in enumerate(tensors)})
  with _single_process():
    dcp.save(state, checkpoint_id=os.path.abspath(path))


def load_distributed(path: str, device="cuda") -> Any:
  """Load a save_distributed tree, its tensors on `device` (the card
  unless the caller asks otherwise). The entries are read into tensors
  shaped from the checkpoint's own metadata."""
  import torch.distributed.checkpoint as dcp
  path = os.path.abspath(path)
  meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
  state = {k: (torch.empty(m.size, dtype=m.properties.dtype)
               if hasattr(m, "size") else None) for k, m in meta.items()}
  with _single_process():
    dcp.load(state, checkpoint_id=path)
  tensors = [state[f"t{i}"] for i in range(len(state) - 1)]
  return _decode(json.loads(state["spec"]), tensors, device)
