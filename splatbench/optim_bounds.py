"""The least time an H100 could take for a step of the optimizer over a
configuration's gaussians (`ParameterClass.step` of the port, FractionalAdam
with unit weights: every group of scalar type, no point or mask rates).

Counted from the configuration alone, whatever implements the step: N is
`scene.points`, D the values a point (position 3, log_scaling 3, rotation
4, alpha_logit 1, the colour features: 3 (sh_degree + 1)^2 SH coefficients
or the raw channels, and the field's channels where the configuration has
a field). Each element is read once from param, grad, m and v and written
once to param, m and v: 7 float32 values, 28 bytes; each point's weight is
read and its total weight read and written: 12 bytes. The decoder's own
`torch.optim.Adam` (the Feature 3DGS cell's W and b) lies outside the
port's step and is not counted. Bytes over the card's memory rate, as in
`splatbench/bounds.py` (the arithmetic, ~20 operations an element, is far
below the FP32 rate).
"""

from typing import Dict

from splatbench.bounds import _bound

ELEMENT_BYTES = 28   # param, grad, m, v read; param, m, v written; float32
POINT_BYTES = 12     # the weight read; the total weight read and written
GEOMETRY_VALUES = 3 + 3 + 4 + 1   # position, log_scaling, rotation, alpha_logit


def values_per_point(cfg: Dict) -> int:
  feat = cfg["features"]
  colour = 3 * (feat["sh_degree"] + 1) ** 2 if feat["kind"] == "sh" else feat["channels"]
  field = cfg["field"]["channels"] if "field" in cfg else 0
  return GEOMETRY_VALUES + colour + field


def step_bound(cfg: Dict) -> Dict[str, float]:
  """The bound of one step: {"bytes", "ms", ...} as `bounds._bound`."""
  n = cfg["scene"]["points"]
  return _bound(0, n * values_per_point(cfg) * ELEMENT_BYTES + n * POINT_BYTES)
