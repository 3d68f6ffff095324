from . import lib
from .projection import CameraParams, project_to_image, project_points
from .sh import evaluate_sh_at, rsh_cart, check_sh_degree

__all__ = [
    "lib",
    "CameraParams",
    "project_to_image",
    "project_points",
    "evaluate_sh_at",
    "rsh_cart",
    "check_sh_degree",
]
