"""3D gaussian renderer (port of
`taichi_gaussian_rasterizer_tpu.models.renderer`).

project -> shade (SH or raw features) -> tile map -> rasterize, with depth
and depth^2 riding the blend as two prepended channels, and median depth
from a second, non-blending pass at saturate_threshold = 0.5 over the same
tile mapping. The render is differentiable: `loss.backward()` after
`render_gaussians` gives gradients for every `Gaussians3D` tensor.
`render_with_heuristics` is the training-mode step: it returns the loss,
the gradients and a rendering whose per-point heuristics and visibility
are filled in from the backward pass. With `compute_visibility` in the
config, a plain render fills `point_visibility` from the forward pass.

`point_features` (N, C), a feature field's per-point vectors (Feature
3DGS's semantic features), are blended in the same pass as the colour,
after it, with the same weights; their image is `Rendering.feature_map`
and their gradient flows back to the tensor passed in. The decoder that
takes such a map to a teacher's width is `models.feature_decoder`.

`visit_chunks`/`visit_capacity` render with saturation-front truncation
(`ops.raster.function.probe_visit_chunks`), and `Rendering.raster_overflow`
then says whether it cropped a tile; the median-depth pass is non-blending
and takes the untruncated mapping. `capacity`, `emit_tails` and
`reduce_capacity` are XLA static-shape knobs and are not part of these
signatures.
"""

from dataclasses import dataclass, fields, replace
from typing import Callable, Optional, Tuple

import torch

from ..config import RasterConfig
from ..data_types import Gaussians3D
from ..ops import lib
from ..ops.mapper import map_to_tiles
from ..ops.projection import CameraParams, project_to_image
from ..ops.raster import rasterize_with_tiles
from ..ops.sh import evaluate_sh_at
from ..utils import tracing


@dataclass(frozen=True)
class Rendering:
  """Renderer outputs. point_heuristic (prune cost, split score) is filled
  in by `render_with_heuristics`, point_visibility by it or by a render
  with config.compute_visibility."""
  image: torch.Tensor                 # (H, W, C)
  image_weight: torch.Tensor          # (H, W) accumulated alpha
  points_in_view: torch.Tensor        # (N,) bool mask
  point_depth: torch.Tensor           # (N, 1)
  gaussians2d: torch.Tensor           # (N, 7)
  camera: CameraParams
  config: RasterConfig
  point_visibility: Optional[torch.Tensor] = None   # (N,) via visibility sink
  point_heuristic: Optional[torch.Tensor] = None    # (N, 2) via heuristic sink
  depth: Optional[torch.Tensor] = None              # (H, W)
  depth_var: Optional[torch.Tensor] = None          # (H, W)
  median_depth: Optional[torch.Tensor] = None       # (H, W)
  raster_overflow: Optional[torch.Tensor] = None    # () bool with visit_chunks:
                                                    # truncation cropped a tile
  feature_map: Optional[torch.Tensor] = None        # (H, W, C) with point_features

  @property
  def ndc_depth(self):
    return lib.ndc_depth(self.depth, self.camera.near_plane,
                         self.camera.far_plane)

  @property
  def ndc_median_depth(self):
    return lib.ndc_depth(self.median_depth, self.camera.near_plane,
                         self.camera.far_plane)

  @property
  def ndc_point_depth(self):
    return lib.ndc_depth(self.point_depth, self.camera.near_plane,
                         self.camera.far_plane)

  @property
  def point_scale(self):
    return self.gaussians2d[:, 4:6]

  @property
  def point_opacity(self):
    return self.gaussians2d[:, 6]

  @property
  def gaussian_scale(self):
    """Cutoff multiple of sigma used for culling."""
    return lib.gaussian_scale_factor(self.point_opacity,
                                     self.config.alpha_threshold)

  @property
  def point_radii(self):
    return torch.amax(self.point_scale, dim=1)

  @property
  def prune_cost(self):
    return self._heuristic()[:, 0]

  @property
  def split_score(self):
    return self._heuristic()[:, 1]

  @property
  def visible_mask(self):
    if self.point_visibility is None:
      raise ValueError("no visibility: render with config.compute_visibility "
                       "or with render_with_heuristics")
    return self.point_visibility > 0

  def _heuristic(self):
    if self.point_heuristic is None:
      raise ValueError("no point heuristic: render with render_with_heuristics")
    return self.point_heuristic

  @property
  def image_size(self) -> Tuple[int, int]:
    return self.camera.image_size

  @property
  def num_points(self) -> int:
    return self.points_in_view.shape[0]

  def detach(self) -> "Rendering":
    """The same rendering with every tensor cut from the autograd graph."""
    def cut(v):
      return v.detach() if isinstance(v, torch.Tensor) else v
    camera = replace(self.camera, projection=self.camera.projection.detach(),
                     T_camera_world=self.camera.T_camera_world.detach())
    return replace(self, camera=camera, **{
        f.name: cut(getattr(self, f.name)) for f in fields(self)
        if f.name != "camera"})

  def replace(self, **kwargs) -> "Rendering":
    return replace(self, **kwargs)


def compute_depth_variance(depth_depthsq, weight, eps=1e-6):
  """E[d], Var[d] from blended [d, d^2] channels."""
  w = weight + eps
  depth = depth_depthsq[..., 0] / w
  depth_sq = depth_depthsq[..., 1] / w
  return depth, depth_sq - depth * depth


def render_projected(in_view: torch.Tensor, gaussians2d: torch.Tensor,
                     features: torch.Tensor, depths: torch.Tensor,
                     camera_params: CameraParams, config: RasterConfig,
                     render_depth: bool = False, use_depth16: bool = False,
                     render_median_depth: bool = False,
                     use_ndc_depth: bool = False,
                     heuristic_sink: Optional[torch.Tensor] = None,
                     visibility_sink: Optional[torch.Tensor] = None,
                     visit_chunks: Optional[torch.Tensor] = None,
                     visit_capacity: Optional[int] = None,
                     point_features: Optional[torch.Tensor] = None) -> Rendering:
  """Rasterize already-projected gaussians. visit_chunks / visit_capacity
  as in `rasterize_with_tiles`: probe them on the same points and
  mapping (`probe_visit_chunks`). point_features (N, C), where given, are
  blended after `features` in the same pass and come back as
  `Rendering.feature_map`."""
  near, far = camera_params.near_plane, camera_params.far_plane
  ndc_depths = lib.ndc_depth(torch.clamp(depths, min=near), near, far)

  n_colour = features.shape[1]
  parts = [features]
  if point_features is not None:
    if point_features.ndim != 2 or point_features.shape[0] != features.shape[0]:
      raise ValueError(f"point_features must be (N, C) with N = {features.shape[0]}, "
                       f"got {tuple(point_features.shape)}")
    parts.append(point_features)
  if render_depth:
    d = ndc_depths if use_ndc_depth else depths
    parts = [d, d * d] + parts
  if len(parts) > 1:
    features = torch.cat(parts, dim=1)

  mapping = map_to_tiles(gaussians2d, ndc_depths[:, 0],
                         camera_params.image_size, config,
                         use_depth16=use_depth16)

  raster = rasterize_with_tiles(
      gaussians2d, features, mapping, camera_params.image_size, config,
      heuristic_sink=heuristic_sink, visibility_sink=visibility_sink,
      visit_chunks=visit_chunks, visit_capacity=visit_capacity)

  median_depth = None
  if render_median_depth:
    d = ndc_depths if use_ndc_depth else depths
    # forward only: the training-mode outputs belong to the main pass
    median_cfg = config.replace(use_alpha_blending=False,
                                saturate_threshold=0.5,
                                compute_point_heuristic=False,
                                compute_visibility=False)
    raster_median = rasterize_with_tiles(
        gaussians2d.detach(), d.detach().contiguous(), mapping,
        camera_params.image_size, median_cfg)
    median_depth = raster_median.image[..., 0]

  img_depth, img_depth_var = None, None
  feature_image = raster.image
  feature_map = None
  if point_features is not None:
    # one split, so that the backward writes one (H, W, F) gradient
    depth_part, feature_image, feature_map = torch.split(
        feature_image, [2 if render_depth else 0, n_colour,
                        point_features.shape[1]], dim=-1)
    if render_depth:
      img_depth, img_depth_var = compute_depth_variance(depth_part,
                                                        raster.image_weight)
  elif render_depth:
    img_depth, img_depth_var = compute_depth_variance(
        feature_image[..., :2], raster.image_weight)
    feature_image = feature_image[..., 2:]

  return Rendering(
      image=feature_image,
      image_weight=raster.image_weight,
      points_in_view=in_view,
      point_depth=depths,
      gaussians2d=gaussians2d,
      camera=camera_params,
      config=config,
      point_visibility=raster.visibility,
      depth=img_depth,
      depth_var=img_depth_var,
      median_depth=median_depth,
      raster_overflow=raster.bin_overflow,
      feature_map=feature_map)


def render_gaussians(gaussians: Gaussians3D,
                     camera_params: CameraParams,
                     config: RasterConfig = RasterConfig(),
                     use_sh: bool = False,
                     render_depth: bool = False,
                     use_depth16: bool = False,
                     render_median_depth: bool = False,
                     heuristic_sink: Optional[torch.Tensor] = None,
                     visibility_sink: Optional[torch.Tensor] = None,
                     visit_chunks: Optional[torch.Tensor] = None,
                     visit_capacity: Optional[int] = None,
                     point_features: Optional[torch.Tensor] = None) -> Rendering:
  """Render 3D gaussians.

  With use_sh=True the features are (N, 3, (d+1)^2) SH coefficients,
  shaded at every point with detached positions; otherwise raw (N, C)
  features. point_features (N, C'), a feature field's per-point vectors,
  are blended after the colour in the same raster pass (3 + C' channels
  with SH) and come back as `Rendering.feature_map` (H, W, C'), the
  colour as `Rendering.image`; None renders exactly as without them.
  visit_chunks / visit_capacity render with saturation-front truncation
  (`render_projected`). Under a torch.profiler profile the call is the
  frame `tgr.render` of `utils.tracing`.
  """
  with tracing.span("render", watch=gaussians):
    gaussians2d, depths, in_view = project_to_image(
        gaussians, camera_params, config)

    if use_sh:
      features = evaluate_sh_at(gaussians.feature, gaussians.position.detach(),
                                camera_params.camera_position)
    else:
      features = gaussians.feature
      if features.ndim != 2:
        raise ValueError(
            f"Features must be (N, C) if use_sh=False, got {tuple(features.shape)}")

    return render_projected(
        in_view, gaussians2d, features, depths, camera_params, config,
        render_depth=render_depth, use_depth16=use_depth16,
        render_median_depth=render_median_depth,
        heuristic_sink=heuristic_sink, visibility_sink=visibility_sink,
        visit_chunks=visit_chunks, visit_capacity=visit_capacity,
        point_features=point_features)


def render_with_heuristics(loss_fn: Callable[[Rendering], torch.Tensor],
                           gaussians: Gaussians3D,
                           camera_params: CameraParams,
                           config: RasterConfig,
                           **render_kwargs):
  """Render, take the loss and run its backward pass in one call.

  The per-point heuristics (prune cost, split score) and visibility are
  the gradients of zero sinks the render takes (the JAX package's
  functional design); this wires them up, with
  config.compute_point_heuristic set, and differentiates the loss with
  respect to the given gaussians' values, like `jax.value_and_grad`: the
  gradients are returned and the gaussians' own `.grad` is left alone.

  Args:
    loss_fn: Rendering -> scalar loss
    render_kwargs: passed on to render_gaussians (use_sh, render_depth, ...)

  Returns:
    (loss, grads (Gaussians3D of gradients), rendering with
    point_heuristic and point_visibility filled in)
  """
  cfg = config.replace(compute_point_heuristic=True)
  leaves = {f.name: getattr(gaussians, f.name).detach().requires_grad_()
            for f in fields(gaussians)}
  pos = leaves["position"]
  sink = pos.new_zeros(pos.shape[0], 2, requires_grad=True)
  vsink = pos.new_zeros(pos.shape[0], requires_grad=True)
  rendering = render_gaussians(Gaussians3D(**leaves), camera_params, cfg,
                               heuristic_sink=sink, visibility_sink=vsink,
                               **render_kwargs)
  loss = loss_fn(rendering)
  *grads, heuristic, visibility = torch.autograd.grad(
      loss, [*leaves.values(), sink, vsink])
  grads = Gaussians3D(**dict(zip(leaves, grads)))
  return loss.detach(), grads, rendering.replace(
      point_heuristic=heuristic, point_visibility=visibility)


def viewspace_gradient(grad_gaussians2d: torch.Tensor) -> torch.Tensor:
  """||dL/dxy|| per point from a gradient of the (N, 7) gaussians2d (the
  classic 3DGS densification signal)."""
  return torch.linalg.vector_norm(grad_gaussians2d[:, :2], dim=1)
