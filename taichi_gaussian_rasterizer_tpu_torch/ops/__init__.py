from . import lib
from .indexing import index_features, mask_features, segmented_sort_pairs
from .projection import CameraParams, project_to_image, project_points
from .sh import evaluate_sh_at, rsh_cart, check_sh_degree

__all__ = [
    "lib",
    "index_features",
    "mask_features",
    "segmented_sort_pairs",
    "CameraParams",
    "project_to_image",
    "project_points",
    "evaluate_sh_at",
    "rsh_cart",
    "check_sh_degree",
]
