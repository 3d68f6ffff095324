"""Raster configuration (PyTorch/CUDA port of `taichi_gaussian_rasterizer_tpu.config`).

Same frozen dataclass, same fields and defaults, so a config written for
the JAX package means the same thing here. Fields that exist only to
shape the TPU kernels or XLA's static shapes are kept, so that configs
carry over unchanged; some of them have no effect in this package:

* ``points_per_chunk`` -- the TPU kernels stage this many gaussians per
  VMEM chunk; the CUDA raster kernels stage their own batches. Here it
  sets only the granularity of saturation-front truncation:
  `probe_visit_chunks` and `truncate_mapping` count each tile's kept
  prefix in chunks of this many slots, as the JAX package does.
* ``saturation_early_exit`` -- the CUDA kernels always stop a tile once
  every pixel has saturated; the blend gates make that exit exact, so
  the output is the same either way. False refuses saturation-front
  truncation (`probe_visit_chunks`, `visit_chunks`, `TruncationGuard`
  raise ValueError), as in the JAX package: truncation is exact only
  where the early exit is.
* ``exact_features`` -- the port never packs features as bf16 pairs;
  features are always blended at full precision.
* ``exact_slot_gradients`` -- the port never packs the backward's slot
  gradient rows as bf16 pairs; they are always full precision.

``deterministic`` holds whatever its value: the mapper sorts stably, so
ties in (tile, depth) blend in a reproducible order, and the gradients
and visibility are reproducible bit for bit -- the raster kernels write
each slot's values once, the reduction sorts stably and sums each
point's slots in order, and no kernel uses atomics. Its one effect is on
``use_depth16`` keys: with it, quantized depth ties are broken on the
full depth (as in the JAX mapper), without it on the point index.

``max_tile_span`` is honoured with the JAX mapper's clamp-and-flag
semantics, so overlap sets match it. ``compute_point_heuristic`` adds
the heuristic rows to the backward, delivered through a heuristic sink
next to a visibility sink (`rasterize_with_tiles`). ``compute_visibility``
(and ``compute_point_heuristic`` without a visibility sink) takes each
point's visibility from the forward kernel instead, in
`RasterOut.visibility`.
"""

from dataclasses import dataclass, replace


@dataclass(frozen=True, eq=True, kw_only=True)
class RasterConfig:
  tile_size: int = 16

  # clamp position to within this margin of the image for the affine Jacobian
  clamp_margin: float = 0.15

  # use the analytic antialiased (box-integrated) gaussian pdf
  antialias: bool = False

  # add blur_cov * I to the projected 2D covariance
  blur_cov: float = 0.3

  clamp_max_alpha: float = 0.99
  alpha_threshold: float = 1.0 / 255.0

  # stop alpha blending once accumulated weight reaches this
  saturate_threshold: float = 0.9999

  # if False, output the feature of the point crossing (1 - saturate_threshold)
  # accumulated weight (quantile/median filter)
  use_alpha_blending: bool = True

  compute_point_heuristic: bool = False  # implies compute_visibility
  compute_visibility: bool = False

  # cap on per-gaussian tile footprint: larger footprints are clamped and
  # flag TileMapping.overflow
  max_tile_span: int = 16
  # saturation-front truncation's granularity, and whether it is allowed
  # (see the module docstring)
  points_per_chunk: int = 128
  saturation_early_exit: bool = True
  # no effect in this package (see the module docstring)
  exact_slot_gradients: bool = False
  deterministic: bool = False
  exact_features: bool = False

  def replace(self, **kwargs) -> "RasterConfig":
    return replace(self, **kwargs)
