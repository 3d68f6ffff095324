"""Per-point sums of slot rows: the CUDA kernels' wrappers and their plain
PyTorch versions (port of `taichi_gaussian_rasterizer_tpu.ops.raster.reduce`).

Two entry points, each launching a hand-written kernel of
`csrc/segment_sum.cu` (which replaces the TPU kernel
`taichi_gaussian_rasterizer_tpu/ops/raster/reduce.py:_segment_sum_kernel`)
on CUDA tensors, or raising, and running the plain version on CPU tensors.
Nothing falls back from a kernel to its plain version.

* `point_sums_by_order`, the gradient reduction: slot rows gathered
  through the stable sort of the slots by point and summed per point; on
  the card in one pass over slot-major rows (`tgr_point_sums`).
* `segment_sums_by_sorted_key`, the JAX function's port: sums of rows
  already sorted by point (`tgr_segment_sum`).

Both kernels add each point's values one at a time in sorted order,
starting from 0, so the first over slot rows equals the second over the
same rows gathered into point order, bit for bit.

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
POINT_SUMS = CudaKernel("segment_sum.cu", "tgr_point_sums",
                        "f32 storage, i64 order, i32 offsets, int rows, int n, "
                        "f32 out")


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


def slot_major(slots: torch.Tensor) -> bool:
  """True where (R, K) slot rows are a view of slot-major (K, R) storage,
  each slot's R values contiguous, as the backward kernel writes them."""
  return slots.T.is_contiguous()


def point_sums_cuda(storage: torch.Tensor, order: torch.Tensor,
                    offsets: torch.Tensor, n: int) -> torch.Tensor:
  """Launch `tgr_point_sums`: float32 slot-major storage (K, R), int64
  order (K,), int32 offsets (N+1,); returns float32 (N, R)."""
  if storage.ndim != 2 or order.shape != (storage.shape[0],):
    raise ValueError(f"storage must be (K, R) and order (K,), got "
                     f"{tuple(storage.shape)} and {tuple(order.shape)}")
  if offsets.shape != (n + 1,):
    raise ValueError(f"offsets must be (N+1,) = ({n + 1},), got "
                     f"{tuple(offsets.shape)}")
  out = torch.empty((n, storage.shape[1]), dtype=torch.float32,
                    device=storage.device)
  POINT_SUMS.launch(storage, order, offsets, storage.shape[1], n, out)
  return out


def point_sums_by_order(keys: torch.Tensor, order: torch.Tensor,
                        slots: torch.Tensor, offsets: torch.Tensor,
                        n: int) -> torch.Tensor:
  """(N, R) per-point sums of (R, K) slot rows.

  keys, order: the stable sort of the slots' point ids (sentinel == n
  sorts last); offsets: (N+1,) int32 start of each point's segment of the
  sorted order (the mapper's point_offsets). Row i is the sum of
  slots[:, order[q]] over q in [offsets[i], offsets[i+1]), added in q
  order from 0: sentinel slots are never summed, an empty segment gives 0.

  On the card the kernel reads each point's slots through `order` from
  slot-major storage (`slot_major`: the backward kernel's own layout; other
  rows are repacked once); on the CPU the rows are gathered into point
  order and summed by `segment_sums_plain`.
  """
  if slots.is_cuda:
    return point_sums_cuda(slots.T.contiguous(), order, offsets, n)
  if slots.device.type != "cpu":
    raise ValueError(f"no point sums for device {slots.device}")
  return segment_sums_plain(keys, slots.index_select(1, order), n).T
