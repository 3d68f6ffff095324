"""The least time an H100 could take for the feature decoder of a Feature
3DGS step (`models/feature_decoder.py` of the port): the bilinear resize of
the rendered (H, W, C_in) map to the teacher's (H', W') with align_corners,
the 1x1 convolution to C_out channels plus bias, and their backward.

Counted from the shapes alone, whatever the implementation: operations are
the three products of P' = H' W' pixels (forward W F, the gradients of W
and of F), 2 P' C_in C_out each, plus the resize and its backward (four
taps a resized value each way: 8 operations a value) and the bias (P'
C_out each way); bytes are each input read once and each output written
once, forward (the map, W, b in; the decoded map out) and backward (the
decoded map's gradient, the resized map and W in; the gradients of the
map, W and b out). TF32 is off, so the operations are over the FP32 rate
outside the tensor cores. Peaks and the max of the two bounds as in
`splatbench/bounds.py`.
"""

from typing import Dict, Tuple

from splatbench.bounds import _bound


def decode_bound(in_size: Tuple[int, int], out_size: Tuple[int, int],
                 c_in: int, c_out: int) -> Dict[str, float]:
  """(H, W) of the rendered map, (H', W') of the teacher's."""
  p_in = in_size[0] * in_size[1]
  p_out = out_size[0] * out_size[1]
  ops = 3 * 2 * p_out * c_in * c_out + 2 * 8 * p_out * c_in + 2 * p_out * c_out
  forward = p_in * c_in + c_out * c_in + c_out + p_out * c_out
  backward = p_out * c_out + p_out * c_in + c_out * c_in \
      + p_in * c_in + c_out * c_in + c_out
  return _bound(ops, 4 * (forward + backward))
