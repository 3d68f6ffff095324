"""Differentiable feature gather and the segmented sort (port of
`taichi_gaussian_rasterizer_tpu.ops.indexing`).

`segmented_sort_pairs` keeps the host contract of the reference's
`cuda_lib` primitive (the JAX package's `io.native` version): it permutes
rows only within the segments [offsets[i], offsets[i+1]), and rows
outside [offsets[0], offsets[-1]) keep their place. The JAX package's
device version sorts those rows too (it clamps them into the first and
last segments); the port does not copy that.
"""

import torch


def index_features(features: torch.Tensor, indexes: torch.Tensor) -> torch.Tensor:
  """(N, ...) rows gathered at (M,) indexes; its gradient is a scatter-add
  into the gathered rows."""
  return features.index_select(0, indexes.to(torch.int64))


def mask_features(features: torch.Tensor, mask: torch.Tensor,
                  fill_value: float = 0.0) -> torch.Tensor:
  """Rows where mask is False set to fill_value, keeping the shape."""
  shape = (-1,) + (1,) * (features.ndim - 1)
  return torch.where(mask.reshape(shape), features,
                     torch.as_tensor(fill_value, dtype=features.dtype,
                                     device=features.device))


def segmented_sort_pairs(keys: torch.Tensor, values: torch.Tensor,
                         offsets: torch.Tensor, stable: bool = True):
  """Sort (keys, values) pairs by key within each segment
  [offsets[i], offsets[i+1]) of non-decreasing offsets; rows outside
  [offsets[0], offsets[-1]) keep their place. With `stable`, equal keys
  keep their order. Returns new (keys, values) tensors on their device.
  """
  offsets = torch.as_tensor(offsets, dtype=torch.int64, device=keys.device)
  keys, values = keys.clone(), values.clone()
  lo, hi = int(offsets[0]), int(offsets[-1])
  if hi <= lo:
    return keys, values
  rows = torch.arange(lo, hi, device=keys.device)
  # segment of each covered row: how many interior boundaries precede it
  seg = torch.searchsorted(offsets[1:-1], rows, right=True)
  # lexicographic (segment, key): sort by key, then stably by segment
  by_key = torch.sort(keys[lo:hi], stable=stable).indices
  order = by_key[torch.sort(seg[by_key], stable=True).indices]
  keys[lo:hi] = keys[lo:hi][order]
  values[lo:hi] = values[lo:hi][order]
  return keys, values
