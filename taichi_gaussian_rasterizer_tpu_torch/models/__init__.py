from .renderer import (Rendering, compute_depth_variance, render_gaussians,
                       render_projected, render_with_heuristics,
                       viewspace_gradient)

__all__ = [
    "Rendering",
    "render_gaussians",
    "render_projected",
    "compute_depth_variance",
    "render_with_heuristics",
    "viewspace_gradient",
]
