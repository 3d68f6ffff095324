"""The least time an H100 could take for a frame's raster work.

Frozen copy of `_bound`, `forward_bound`, `backward_bound` and
`segment_sum_bound` with their constants, from
`taichi_gaussian_rasterizer_tpu_torch/ops/raster/bounds.py` at commit
7e9dc73bdb561296269ff5d4d0e4f9081da37a53. Only what does not depend on an
implementation is kept: the counts it takes are the frame's active (pixel,
slot) pairs (`reference.raster_forward` counts them: inside the image,
within the pixel's open saturation gate, alpha over the threshold), its
points, features, pixels, slots and tiles. The per-warp counts of the
original describe one kernel layout and are left out.

A bound is the larger of the bytes the function must move (each input
read once, each output written once) over the card's memory rate and its
FP32 operations over the card's FP32 rate, at the published H100 SXM
peaks (700 W). `tests/test_splatbench_bounds.py` holds these functions and
the active count equal to the original's on a small frame.
"""

from typing import Dict, Tuple

PEAK_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3

EVAL_OPS = {False: 15, True: 54}
FORWARD_ACTIVE_OPS = 9
BACKWARD_ACTIVE_OPS = 18
BACKWARD_POINT_ROW_OPS = {False: 20, True: 75}
BACKWARD_HEURISTIC_OPS = 8


def _bound(ops: float, nbytes: float) -> Dict[str, float]:
  t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
  return {"ops": ops, "bytes": nbytes, "ms": max(t_ops, t_bytes) * 1e3,
          "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def forward_bound(work: Dict[str, int], n_points: int, n_features: int,
                  n_slots: int, n_tiles: int, image_size: Tuple[int, int],
                  antialias: bool, visibility: bool = False) -> Dict[str, float]:
  f = n_features
  ops = work["active"] * (EVAL_OPS[antialias] + FORWARD_ACTIVE_OPS + 2 * f
                          + int(visibility))
  w, h = image_size
  nbytes = 4 * (n_points * (7 + f) + n_slots + 2 * n_tiles
                + w * h * (f + 1) + (n_slots if visibility else 0))
  return _bound(ops, nbytes)


def backward_bound(work: Dict[str, int], n_points: int, n_features: int,
                   n_slots: int, n_tiles: int, image_size: Tuple[int, int],
                   antialias: bool, heuristic: bool,
                   visibility: bool) -> Dict[str, float]:
  f = n_features
  rows = ((7 if antialias else 6) + (2 if heuristic else 0)
          + int(visibility) + f)
  ops = work["active"] * (
      EVAL_OPS[antialias] + BACKWARD_ACTIVE_OPS + 4 * f
      + BACKWARD_POINT_ROW_OPS[antialias]
      + (BACKWARD_HEURISTIC_OPS if heuristic else 0) + int(visibility))
  w, h = image_size
  nbytes = 4 * (n_points * (7 + f) + n_slots + 2 * n_tiles
                + 2 * w * h * (f + 1) + rows * n_slots)
  return _bound(ops, nbytes)


def segment_sum_bound(rows: int, n_slots: int, n_points: int) -> Dict[str, float]:
  return _bound(rows * n_slots, 4 * (rows * n_slots + n_points + 1 + rows * n_points))


def backward_rows(n_features: int) -> int:
  """The slot rows a training frame's backward writes and the reduction
  sums (no heuristic, no visibility, no antialias): 6 point rows and one
  a feature."""
  return 6 + n_features
