from . import renderer2d
from .feature_decoder import FeatureDecoder, decode_features
from .renderer import (Rendering, compute_depth_variance, render_gaussians,
                       render_projected, render_with_heuristics,
                       viewspace_gradient)

__all__ = [
    "renderer2d",
    "FeatureDecoder",
    "decode_features",
    "Rendering",
    "render_gaussians",
    "render_projected",
    "compute_depth_variance",
    "render_with_heuristics",
    "viewspace_gradient",
]
