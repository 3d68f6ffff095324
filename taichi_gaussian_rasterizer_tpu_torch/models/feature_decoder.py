"""The feature field's decoder (Feature 3DGS's speed-up module): a rendered
feature map resized to a teacher's size and lifted to the teacher's width
by a 1x1 convolution.

Feature 3DGS (Zhou et al., CVPR 2024, arXiv:2312.03203) renders a
low-width feature map F (H, W, C) in the same pass as the colour
(`render_gaussians(..., point_features=...)`), resizes it bilinearly to
the teacher's (H', W') with `align_corners=True`, and decodes it with a
learned 1x1 convolution D(F) = W F + b, W (C_out, C_in), to the teacher's
width (LSeg: 512 from 128). The loss holds D(resize(F)) to the teacher's
map.

Here the resize is `F.interpolate` and the convolution one matrix
product over the resized pixels, forward and backward, in one autograd
Function so that each direction is one span of `utils.tracing`:
`tgr.field.decode` and `tgr.field.decode.bwd` (the backward's parent is
the forward's span, so both share its frame), each with counts `pixels`
(H' W'), `in_channels` and `out_channels`. Maps are channel-last: (H, W,
C_in) in, (H', W', C_out) out, so that the out map lies as a teacher's
(H', W', 512) does. The products follow the caller's precision setting
(`torch.backends.cuda.matmul.allow_tf32`, off by default: FP32).
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing


def _to_nchw(feature_map: torch.Tensor) -> torch.Tensor:
  """(H, W, C) -> a channels-last (1, C, H, W): a view where the map is
  contiguous, else one copy."""
  return feature_map.permute(2, 0, 1)[None].contiguous(
      memory_format=torch.channels_last)


def _counts(s, size: Tuple[int, int], c_in: int, c_out: int) -> None:
  s.count(pixels=size[0] * size[1], in_channels=c_in, out_channels=c_out)


class _Decode(torch.autograd.Function):
  """(H, W, C_in) map, W (C_out, C_in), b (C_out,), (H', W') -> (H', W',
  C_out)."""

  @staticmethod
  def forward(ctx, feature_map, weight, bias, size):
    with tracing.span("field.decode") as s:
      _counts(s, size, weight.shape[1], weight.shape[0])
      ctx.trace_parent = tracing.current()
      x = _to_nchw(feature_map)
      resized = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
      rows = resized[0].permute(1, 2, 0).reshape(-1, weight.shape[1])
      out = torch.addmm(bias, rows, weight.T)
    ctx.save_for_backward(rows, weight)
    ctx.in_size = tuple(feature_map.shape[:2])
    ctx.size = tuple(size)
    return out.reshape(size[0], size[1], weight.shape[0])

  @staticmethod
  def backward(ctx, grad):
    rows, weight = ctx.saved_tensors
    c_out, c_in = weight.shape
    h, w = ctx.in_size
    with tracing.span("field.decode.bwd", parent=ctx.trace_parent) as s:
      _counts(s, ctx.size, c_in, c_out)
      g = grad.reshape(-1, c_out)
      g_weight = g.T @ rows if ctx.needs_input_grad[1] else None
      g_bias = g.sum(0) if ctx.needs_input_grad[2] else None
      g_map = None
      if ctx.needs_input_grad[0]:
        g_rows = g @ weight                                   # (H' W', C_in)
        g_resized = g_rows.reshape(1, ctx.size[0], ctx.size[1], c_in).permute(0, 3, 1, 2)
        g_x = torch.ops.aten.upsample_bilinear2d_backward(
            g_resized, list(ctx.size), [1, c_in, h, w], True)
        g_map = g_x[0].permute(1, 2, 0)
    return g_map, g_weight, g_bias, None


def decode_features(feature_map: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
  """D(resize(F)): the (H, W, C_in) map resized bilinearly (align_corners)
  to size = (H', W'), then W (C_out, C_in) and b (C_out,) at every pixel:
  (H', W', C_out). Differentiable in all three tensors."""
  if feature_map.ndim != 3 or feature_map.shape[2] != weight.shape[1]:
    raise ValueError(f"feature_map must be (H, W, {weight.shape[1]}), "
                     f"got {tuple(feature_map.shape)}")
  if bias.shape != (weight.shape[0],):
    raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
  return _Decode.apply(feature_map, weight, bias, (int(size[0]), int(size[1])))


class FeatureDecoder(torch.nn.Module):
  """The learned 1x1 convolution C_in -> C_out after a resize to the
  teacher's size. `weight` (C_out, C_in) and `bias` (C_out,) start as
  `torch.nn.Conv2d`'s do, uniform within +-1/sqrt(C_in)."""

  def __init__(self, in_channels: int, out_channels: int, device=None):
    super().__init__()
    bound = in_channels ** -0.5
    w = torch.rand((out_channels, in_channels), device=device)
    b = torch.rand((out_channels,), device=device)
    self.weight = torch.nn.Parameter((w * 2 - 1) * bound)
    self.bias = torch.nn.Parameter((b * 2 - 1) * bound)

  def forward(self, feature_map: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return decode_features(feature_map, self.weight, self.bias, size)
