"""Host-side primitives: the 3DGS PLY reader, Morton codes and the
reference's `cuda_lib` sort and scan primitives (port of
`taichi_gaussian_rasterizer_tpu.io.native`).

The JAX package binds a C++ host library (`csrc/tgr_host.cpp`) with
ctypes. The port keeps its own code for the same API and compiles
nothing: the PLY reader parses the header in Python and reads the
payload with one `np.fromfile`; the sorts, the scan and the Morton codes
are tensor functions that run on the tensor's device with `torch.sort`
and `torch.cumsum`, the role the reference's `cuda_lib` plays.

Keys are non-negative integer tensors; int64 holds the host library's
uint32 keys (and uint64 keys below 2**63).
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.indexing import segmented_sort_pairs
from ..utils.morton import spread_bits32


def _parse_header(path: str) -> Tuple[int, List[str], int]:
  """(n_vertices, float property names, payload offset) of a binary
  little-endian PLY whose first element is `vertex`; IOError otherwise."""
  n, names, binary_le, in_vertex = 0, [], False, False
  with open(path, "rb") as f:
    if not f.readline().startswith(b"ply"):
      raise IOError(f"{path}: not a PLY file")
    for raw in f:
      tok = raw.decode("ascii", errors="replace").split()
      if not tok:
        continue
      if tok[0] == "format":
        binary_le = len(tok) > 1 and tok[1] == "binary_little_endian"
      elif tok[0] == "element":
        in_vertex = tok[1] == "vertex"
        if in_vertex:
          n = int(tok[2])
      elif tok[0] == "property" and in_vertex:
        if tok[1] not in ("float", "float32"):
          raise IOError(f"{path}: vertex property {tok[-1]} is {tok[1]}, "
                        f"not float")
        names.append(tok[2])
      elif tok[0] == "end_header":
        if not (binary_le and n > 0 and names):
          raise IOError(f"{path}: not a binary little-endian PLY with "
                        f"float vertex properties")
        return n, names, f.tell()
  raise IOError(f"{path}: no end_header")


def ply_info(path: str) -> Tuple[int, List[str]]:
  """(n_vertices, property names) of a binary-LE PLY vertex element."""
  n, names, _ = _parse_header(path)
  return n, names


def load_ply(path: str) -> Tuple[np.ndarray, List[str]]:
  """All float vertex properties of a binary-LE PLY as a dense (n,
  n_props) float32 array; IOError when the payload is shorter than the
  header says."""
  n, names, offset = _parse_header(path)
  data = np.fromfile(path, dtype="<f4", count=n * len(names), offset=offset)
  if data.size != n * len(names):
    raise IOError(f"{path}: {data.size} floats, the header promises "
                  f"{n * len(names)}")
  return data.astype(np.float32, copy=False).reshape(n, len(names)), names


def morton3d(xyz: torch.Tensor, resolution: int = 1024) -> torch.Tensor:
  """(N, 3) float32 -> (N,) int64 Morton codes with the host library's
  formula, cell = trunc((xyz - lower) * inv_cell), inv_cell =
  resolution / extent in float32. It rounds otherwise than
  `utils.morton.morton_codes`, which divides by the cell size."""
  xyz = xyz.to(torch.float32)
  lower = torch.amin(xyz, dim=0)
  inv_cell = resolution / torch.clamp(torch.amax(xyz, dim=0) - lower, min=1e-12)
  cells = torch.clamp(((xyz - lower) * inv_cell).to(torch.int64), 0, resolution - 1)
  return (spread_bits32(cells[:, 0]) | (spread_bits32(cells[:, 1]) << 1)
          | (spread_bits32(cells[:, 2]) << 2))


def radix_sort_pairs(keys: torch.Tensor, values: torch.Tensor,
                     begin_bit: int = 0, end_bit: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Stable sort of (keys, values) by the key bits [begin_bit, end_bit)
  (default: every bit of the key type). Returns the whole keys and the
  values in that order."""
  if end_bit is None:
    end_bit = keys.element_size() * 8
  field = keys.to(torch.int64) >> begin_bit
  if end_bit - begin_bit < 63:
    field = field & ((1 << (end_bit - begin_bit)) - 1)
  order = torch.sort(field, stable=True).indices
  return keys[order], values[order]


def radix_argsort(keys: torch.Tensor, **kwargs) -> torch.Tensor:
  """The order radix_sort_pairs sorts keys into."""
  values = torch.arange(keys.shape[0], device=keys.device)
  return radix_sort_pairs(keys, values, **kwargs)[1]


def full_cumsum(counts: torch.Tensor) -> Tuple[torch.Tensor, int]:
  """(N,) -> ((N+1,) int64 exclusive scan, the grand total)."""
  out = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=counts.device)
  torch.cumsum(counts.to(torch.int64), 0, out=out[1:])
  return out, int(out[-1])


__all__ = ["ply_info", "load_ply", "morton3d", "radix_sort_pairs",
           "radix_argsort", "full_cumsum", "segmented_sort_pairs"]
