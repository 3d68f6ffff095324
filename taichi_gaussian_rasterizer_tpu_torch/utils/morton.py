"""3D Morton-code spatial sorting (port of
`taichi_gaussian_rasterizer_tpu.utils.morton`).

Quantize points into a grid, interleave the cell coordinates' bits into a
Morton code, and (arg)sort for memory-coherent point order. The codes are
the JAX package's uint32 values held in int64 tensors (torch has no
general uint32 arithmetic); the sort is a stable `torch.sort`, so equal
codes keep their index order, as the JAX package's `lax.sort` does.
"""

from typing import Optional, Tuple

import torch


def spread_bits32(x: torch.Tensor) -> torch.Tensor:
  """Spread the low 10 bits of x so that consecutive bits lie 3 apart
  (the standard 3D Morton interleave). int64."""
  x = x.to(torch.int64) & 0x3FF
  x = (x | (x << 16)) & 0x030000FF
  x = (x | (x << 8)) & 0x0300F00F
  x = (x | (x << 4)) & 0x030C30C3
  x = (x | (x << 2)) & 0x09249249
  return x


def morton_codes(points: torch.Tensor,
                 lower: Optional[torch.Tensor] = None,
                 upper: Optional[torch.Tensor] = None,
                 resolution: int = 1024) -> torch.Tensor:
  """(N, 3) points -> (N,) int64 Morton codes over a bounding grid of
  `resolution` cells an axis (at most 1024: 10 bits an axis)."""
  if resolution > 1024:
    raise ValueError(f"resolution {resolution} > 1024 (10 bits an axis)")
  if lower is None:
    lower = torch.amin(points, dim=0)
  if upper is None:
    upper = torch.amax(points, dim=0)
  inc = (upper - lower) / resolution
  cell = torch.clamp(((points - lower) / inc).to(torch.int32), 0, resolution - 1)
  return (spread_bits32(cell[:, 0]) | (spread_bits32(cell[:, 1]) << 1)
          | (spread_bits32(cell[:, 2]) << 2))


def argsort(points: torch.Tensor, **kwargs) -> torch.Tensor:
  """Indices that sort points along the Morton curve (ties in index
  order)."""
  return torch.sort(morton_codes(points, **kwargs), stable=True).indices


def sort(points: torch.Tensor, *tensors, **kwargs):
  """Reorder points (and any parallel tensors) along the Morton curve."""
  order = argsort(points, **kwargs)
  out = tuple(t[order] for t in (points,) + tensors)
  return out if tensors else out[0]


def argsort_unique(points: torch.Tensor,
                   **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
  """Morton argsort plus a mask marking the first point of each occupied
  cell."""
  codes, order = torch.sort(morton_codes(points, **kwargs), stable=True)
  first = torch.ones_like(codes, dtype=torch.bool)
  first[1:] = codes[1:] != codes[:-1]
  return order, first
