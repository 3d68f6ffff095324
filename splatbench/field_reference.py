"""The plain reference of a Feature 3DGS training step: the joint blend of
colour and semantic features, the resize, the 1x1 decoder, the loss and
its gradients, and the two optimizers, in plain PyTorch.

Feature 3DGS (Zhou et al., "Feature 3DGS: Supercharging 3D Gaussian
Splatting to Enable Distilled Feature Fields", CVPR 2024, arXiv:2312.03203;
its speed-up module with an LSeg teacher):

* each gaussian carries SH colour coefficients and a semantic feature
  f_i (C = 128 channels); colour and feature are alpha-blended in one pass
  with the same weights, C_p = sum_i c_i a_i T_i and F_p = sum_i f_i a_i T_i;
* the feature map is resized bilinearly (align_corners) to the teacher's
  (H', W') and decoded by a 1x1 convolution D(F) = W F + b, W (512, 128);
* L = L1(image, target) + gamma L1(D(resize(F)), teacher), gamma = 1;
* the decoder's W and b step by Adam (lr 1e-4), the gaussians' groups,
  the semantic features among them, by FractionalAdam.

Departures from the paper: the D-SSIM term (lambda 0.2) is left out of the
colour loss, as the `bicycle6m` cells' L1 leaves it out; no densification;
the teacher maps (LSeg's, in the paper) are seeded, each pixel's
512-vector of unit length.

It imports torch and the benchmark's own plain reference
(`splatbench/reference.py`: projection, SH, mapping, the blend in blocks
of tiles and its gradient by autograd, FractionalAdam) only: nothing of
the port (`taichi_gaussian_rasterizer_tpu_torch`), nothing of the JAX
package and nothing of JAX. The resize is written out (four taps, weights
from the align_corners grid) and not taken from `F.interpolate`. Every
product is float32 with TF32 off; `tf32=True` computes the blend's channel
sums, the SH contraction and the decoder's product with both operands
rounded to TF32 (the control that the comparison has to fail).

The repository's tests (`tests/test_torch_feature_field.py`) hold the
port to it on the CPU.
"""

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from splatbench import reference

DECODER_KEYS = ("decoder_weight", "decoder_bias")


def render_joint(gaussians: Dict, semantic: torch.Tensor, camera: Dict, cfg: Dict,
                 tf32: bool = False) -> Dict:
  """The joint blend of the SH colour (N, 3) and the semantic features
  (N, C) of `gaussians` under `camera`: dict(image (H, W, 3), feature_map
  (H, W, C), weight (H, W), and what the gradient needs: points, feats
  (N, 3 + C), mapping, walked, active). Differentiable up to points and
  feats."""
  if cfg["render_depth"] or cfg["features"]["kind"] != "sh":
    raise ValueError("a Feature 3DGS frame blends SH colour and semantic "
                     "features, without depth")
  rc = reference.raster_config(cfg)
  near, far = camera["near_plane"], camera["far_plane"]
  size = tuple(camera["image_size"])
  with reference.no_tf32():
    points, depth, _ = reference.project_points(
        gaussians["position"], gaussians["log_scaling"], gaussians["rotation"],
        gaussians["alpha_logit"], camera["T_camera_world"], camera["projection"],
        size, (near, far), blur_cov=rc["blur_cov"],
        clamp_margin=rc["clamp_margin"], alpha_threshold=rc["alpha_threshold"])
    colors = reference.evaluate_sh_at(
        gaussians["feature"], gaussians["position"].detach(),
        reference.camera_position(camera["T_camera_world"]), tf32)
    feats = torch.cat([colors, semantic], 1)
    ndc = reference.ndc_depth(torch.clamp(depth.detach(), min=near), near, far)[:, 0]
    mapping = reference.map_to_tiles(points.detach(), ndc, size, rc["tile_size"],
                                     rc["alpha_threshold"], rc["max_tile_span"])
  out = reference.raster_forward(points.detach(), feats.detach().contiguous(),
                                 mapping, size, rc, tf32)
  return dict(image=out["image"][..., :3], feature_map=out["image"][..., 3:],
              weight=out["weight"], raw_image=out["image"], points=points,
              feats=feats, mapping=mapping, walked=out["walked"],
              active=out["active"], rc=rc, size=size)


def _taps(n_in: int, n_out: int, device, dtype):
  """The align_corners grid of one axis: (lower index, upper index,
  weight of the upper) for each of n_out outputs."""
  scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
  src = torch.arange(n_out, device=device, dtype=torch.float64) * scale
  lo = torch.clamp(torch.floor(src).to(torch.int64), max=n_in - 1)
  hi = torch.clamp(lo + 1, max=n_in - 1)
  return lo, hi, (src - lo).to(dtype)


def resize(feature_map: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
  """(H, W, C) -> (H', W', C), size = (H', W'): bilinear, align_corners
  (output pixel i samples input row i (H - 1) / (H' - 1), and likewise the
  columns)."""
  h, w, _ = feature_map.shape
  y0, y1, wy = _taps(h, size[0], feature_map.device, feature_map.dtype)
  x0, x1, wx = _taps(w, size[1], feature_map.device, feature_map.dtype)
  wx = wx[None, :, None]
  top = feature_map[y0]
  bottom = feature_map[y1]
  top = top[:, x0] * (1 - wx) + top[:, x1] * wx
  bottom = bottom[:, x0] * (1 - wx) + bottom[:, x1] * wx
  return top * (1 - wy)[:, None, None] + bottom * wy[:, None, None]


def decode(feature_map: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           size: Tuple[int, int], tf32: bool = False) -> torch.Tensor:
  """D(resize(F)): (H, W, C_in) -> (H', W', C_out) with W (C_out, C_in),
  b (C_out,)."""
  with reference.no_tf32():
    rows = resize(feature_map, size).reshape(1, -1, weight.shape[1])
    out = reference.bmm(rows, weight.T[None], tf32)[0] + bias
  return out.reshape(size[0], size[1], weight.shape[0])


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.mean(torch.abs(a - b))


def loss_and_grads(gaussians: Dict, decoder: Dict, camera: Dict, cfg: Dict,
                   target: torch.Tensor, teacher: torch.Tensor,
                   tf32: bool = False, rows: Optional[slice] = None):
  """(loss, {key: gradient}) of one camera's Feature 3DGS loss at
  `gaussians` (the five gaussian tensors and `semantic_feature`) and
  `decoder` (`decoder_weight`, `decoder_bias`); with `rows`, the loss of
  those rows of the image and of the teacher's map alone."""
  field = cfg["field"]
  leaves = {k: v.detach().requires_grad_() for k, v in gaussians.items()}
  dec = {k: v.detach().requires_grad_() for k, v in decoder.items()}
  r = render_joint(leaves, leaves["semantic_feature"], camera, cfg, tf32)
  raw = r["raw_image"].detach().requires_grad_()
  wgt = r["weight"].detach().requires_grad_()
  image, fmap = raw[..., :3], raw[..., 3:]
  decoded = decode(fmap, dec["decoder_weight"], dec["decoder_bias"],
                   tuple(field["teacher_size"][::-1]), tf32)
  if rows is not None:
    image, target = image[rows], target[rows]
    t_rows = slice(rows.start * teacher.shape[0] // raw.shape[0],
                   rows.stop * teacher.shape[0] // raw.shape[0])
    decoded, teacher = decoded[t_rows], teacher[t_rows]
  value = l1(image, target) + field["feature_loss_weight"] * l1(decoded, teacher)
  g_raw, g_wgt, g_w, g_b = torch.autograd.grad(
      value, [raw, wgt, dec["decoder_weight"], dec["decoder_bias"]],
      allow_unused=True)
  g_wgt = torch.zeros_like(wgt) if g_wgt is None else g_wgt
  g_pts, g_fts = reference.raster_vjp(
      r["points"].detach(), r["feats"].detach(), r["mapping"], r["size"], r["rc"],
      r["walked"], g_raw.contiguous(), g_wgt.contiguous(), tf32)
  with reference.no_tf32():
    torch.autograd.backward([r["points"], r["feats"]], [g_pts, g_fts])
  grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
           for k, v in leaves.items()}
  grads.update(decoder_weight=g_w, decoder_bias=g_b)
  return value.detach(), grads


class Adam:
  """torch.optim.Adam's update (no weight decay, no amsgrad), as the
  decoder's W and b step in Feature 3DGS."""

  def __init__(self, params: Dict, lr: float, betas=(0.9, 0.999), eps=1e-8):
    self.params = {k: v.detach().clone() for k, v in params.items()}
    self.lr, self.betas, self.eps = lr, betas, eps
    self.m = {k: torch.zeros_like(v) for k, v in params.items()}
    self.v = {k: torch.zeros_like(v) for k, v in params.items()}
    self.t = 0

  def step(self, grads: Dict) -> None:
    b1, b2 = self.betas
    self.t += 1
    bias1, bias2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
    for k, p in self.params.items():
      g = grads[k]
      self.m[k] = self.m[k] * b1 + g * (1.0 - b1)
      self.v[k] = self.v[k] * b2 + g * g * (1.0 - b2)
      denom = torch.sqrt(self.v[k]) / math.sqrt(bias2) + self.eps
      p -= (self.lr / bias1) * self.m[k] / denom


def train_steps(init: Dict, decoder_init: Dict, lrs: Dict, decoder_lr: float,
                cameras, cfg: Dict, targets: Callable, steps: int,
                tf32: bool = False, rows: Optional[slice] = None) -> Dict:
  """`steps` training steps from `init` and `decoder_init`, step i on
  cameras[i] against targets(i) = (image, teacher): dict(losses, g1 (the
  first step's gradients, (rows, -1)), after (every tensor after the
  steps), init)."""
  opt = reference.FractionalAdam(init, lrs)
  dec = Adam(decoder_init, decoder_lr)
  losses, g1 = [], None
  for i in range(steps):
    target, teacher = targets(i)
    loss, grads = loss_and_grads(opt.params, dec.params, cameras[i], cfg,
                                 target, teacher, tf32, rows)
    losses.append(float(loss))
    if i == 0:
      g1 = {k: g.reshape(g.shape[0], -1) for k, g in grads.items()}
    opt.step(grads)
    dec.step({k: grads[k] for k in DECODER_KEYS})
  return dict(losses=losses, g1=g1, after=dict(opt.params, **dec.params),
              init=dict(init, **decoder_init))
