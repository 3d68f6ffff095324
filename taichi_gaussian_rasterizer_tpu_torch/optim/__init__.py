from .kernels import (MomentState, adam_lr_step, laprop_lr_step, saturate,
                      update_visibility, exp_lerp, power_lerp)
from .parameter_class import (
    GroupConfig, OptimizerSpec, ParameterClass,
    FractionalAdam, FractionalLaProp, SparseAdam, SparseLaProp,
    VisibilityAwareAdam, VisibilityAwareLaProp)

__all__ = [
    "MomentState", "adam_lr_step", "laprop_lr_step", "saturate",
    "update_visibility", "exp_lerp", "power_lerp",
    "GroupConfig", "OptimizerSpec", "ParameterClass",
    "FractionalAdam", "FractionalLaProp", "SparseAdam", "SparseLaProp",
    "VisibilityAwareAdam", "VisibilityAwareLaProp",
]
