"""Segment sums of point-sorted slot rows: the CUDA kernel's wrapper and
its plain PyTorch version (port of
`taichi_gaussian_rasterizer_tpu.ops.raster.reduce`).

`segment_sums_by_sorted_key` is the one entry point. On a CUDA tensor it
launches the hand-written kernel `csrc/segment_sum.cu` (which replaces the
TPU kernel `taichi_gaussian_rasterizer_tpu/ops/raster/reduce.py:
_segment_sum_kernel`) or raises; on a CPU tensor it runs
`segment_sums_plain`. Nothing falls back from the kernel to the plain
version.

Two options of the JAX function are not carried over: uint32 values read
as bf16 pairs (transport packing for the TPU's sort payloads; the port's
slot rows are always full precision) and `block_offsets` (segment bounds
recovered from the keys, which the JAX package's truncated mapping needs:
the port's `truncate_mapping` recomputes `point_offsets` for the kept
slots instead).
"""

from typing import Optional

import torch

from ...utils.cuda_build import CudaKernel

SEGMENT_SUM = CudaKernel("segment_sum.cu", "tgr_segment_sum",
                         "f32 values, i32 offsets, int rows, long long k, "
                         "int n, f32 out")


def segment_sums_plain(keys: torch.Tensor, values: torch.Tensor,
                       n: int) -> torch.Tensor:
  """(R, N) sums of the columns of values (R, K) grouped by key: column i
  sums the values whose key is i. Keys equal to n (sentinels) go to a row
  that is dropped."""
  r = values.shape[0]
  out = values.new_zeros(n + 1, r)
  out.index_add_(0, keys.to(torch.int64), values.T)
  return out[:n].T


def segment_sums_cuda(values: torch.Tensor, offsets: torch.Tensor,
                      n: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Launch the CUDA kernel: float32 values (R, K), int32 offsets (N+1,);
  into `out`, a contiguous float32 (R, N), where given."""
  if values.ndim != 2 or offsets.shape != (n + 1,):
    raise ValueError(f"values must be (R, K) and offsets (N+1,) = ({n + 1},), "
                     f"got {tuple(values.shape)} and {tuple(offsets.shape)}")
  r, k = values.shape
  if out is None:
    out = torch.empty((r, n), dtype=torch.float32, device=values.device)
  elif out.shape != (r, n):
    raise ValueError(f"out must be ({r}, {n}), got {tuple(out.shape)}")
  SEGMENT_SUM.launch(values, offsets, r, k, n, out)
  return out


def segment_sums_by_sorted_key(keys: torch.Tensor, values: torch.Tensor,
                               offsets: torch.Tensor, n: int,
                               out: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Dense per-point sums of point-sorted slot values.

  keys: (K,) int32 ascending point ids (sentinel == n sorts last);
  values: (R, K) in the same order; offsets: (N+1,) int32 start of each
  point's segment (the mapper's point_offsets); n: number of points.
  Returns (R, N): column i is the sum of the values whose key is i; an
  empty segment gives 0 and sentinel slots are never summed. With `out`
  (R, N), the sums are written there and `out` is returned.

  The CUDA kernel reads the segments from `offsets`, the plain version
  groups by `keys`; both give the same sums when offsets are the keys'
  segment starts.
  """
  if values.is_cuda:
    return segment_sums_cuda(values, offsets, n, out)
  if values.device.type != "cpu":
    raise ValueError(f"no segment sum for device {values.device}")
  sums = segment_sums_plain(keys, values, n)
  return sums if out is None else out.copy_(sums)
