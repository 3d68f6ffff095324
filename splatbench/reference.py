"""The plain reference: the port's render and training step written again
in plain PyTorch, computed in blocks of tiles so that it fits a card.

It imports torch only: nothing of the port (`taichi_gaussian_rasterizer_
tpu_torch`), nothing of the JAX package and nothing of JAX. It takes the
benchmark's seeded inputs (the 3D gaussians, the cameras, the targets) and
works out everything the port derives from them again: the projection, the
SH colours, the tile mapping, the blend, the gradients and the optimizer.

Frozen copies, from commit 7e9dc73bdb561296269ff5d4d0e4f9081da37a53:

* `project_points` from `taichi_gaussian_rasterizer_tpu_torch/ops/
  projection.py` and `gaussian_scale_factor` from `ops/lib.py`;
* `rsh_cart` and `evaluate_sh_at` from `ops/sh.py`;
* `map_to_tiles` (its 64-bit key path) from `ops/mapper.py`;
* the conic pdf of `_pdf_alpha` from `ops/raster/forward.py`;
* the FractionalAdam update (unit weights, scalar groups) from
  `optim/kernels.py` and `optim/parameter_class.py`.

The blend is the JAX package's semantics as the port's plain version
computes it (`rasterize_tiles_plain`), but walked in chunks of slots with
the transmittance carried from chunk to chunk, and each tile dropped once
every one of its pixels inside the image has saturated: later slots then
carry no weight and no gradient, so the cut is exact. The gradients are
autograd's, replayed tile group by tile group over the slots the forward
walked (`raster_vjp`), then chained through the projection and the SH by
autograd.

`tf32=True` computes every product of the reference (the SH contraction,
the blend's channel sums and their gradients) with both operands rounded
to TF32 (10 mantissa bits, round to nearest even) and f32 accumulation:
the control that the comparison has to fail.
"""

import math
from typing import Callable, Dict, Optional, Tuple

import torch

# elements of one (tiles, pixels, slots) field a block materializes
BLOCK_ELEMENTS = 1 << 23
CHUNK = 128
SENTINEL_ROW = (0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0)


class no_tf32:
  """Plain float32 products inside the block (TF32 off), restored after."""

  def __enter__(self):
    self.saved = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

  def __exit__(self, *exc):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = self.saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
  """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
  i = x.contiguous().view(torch.int32)
  i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
  return i.view(torch.float32)


class _Tf32Bmm(torch.autograd.Function):
  """a @ b with both operands rounded to TF32, and its gradients the
  same way."""

  @staticmethod
  def forward(ctx, a, b):
    ra, rb = round_tf32(a), round_tf32(b)
    ctx.save_for_backward(ra, rb)
    return torch.bmm(ra, rb)

  @staticmethod
  def backward(ctx, g):
    ra, rb = ctx.saved_tensors
    rg = round_tf32(g)
    return torch.bmm(rg, rb.transpose(1, 2)), torch.bmm(ra.transpose(1, 2), rg)


def bmm(a, b, tf32: bool):
  return _Tf32Bmm.apply(a, b) if tf32 else torch.bmm(a, b)


# -- frozen: ops/lib.py, ops/projection.py ----------------------------------


def gaussian_scale_factor(alpha, alpha_threshold):
  ratio = torch.clamp(alpha / alpha_threshold, min=1.0)
  return torch.sqrt(2.0 * torch.log(ratio))


def ndc_depth(depth, near, far):
  return 1.0 - (1.0 / depth - 1.0 / far) / (1.0 / near - 1.0 / far)


def camera_position(T_camera_world: torch.Tensor) -> torch.Tensor:
  R, t = T_camera_world[:3, :3], T_camera_world[:3, 3]
  return -torch.stack(
      [R[0, i] * t[0] + R[1, i] * t[1] + R[2, i] * t[2] for i in range(3)])


def project_points(position, log_scaling, rotation, alpha_logit,
                   T_camera_world, projection, image_size, depth_range,
                   blur_cov=0.3, clamp_margin=0.15, alpha_threshold=1.0 / 255.0):
  """(points (N, 7) [mean, axis, sigma, alpha], depth (N, 1), in_view (N,))."""
  dtype = position.dtype
  T = T_camera_world.to(dtype)
  fx, fy, cx, cy = (projection.to(dtype)[i] for i in range(4))
  w_size, h_size = image_size
  pxw, pyw, pzw = position[:, 0], position[:, 1], position[:, 2]
  qx, qy, qz, qw = (rotation[:, i] for i in range(4))
  qn = torch.sqrt(torch.clamp(qx * qx + qy * qy + qz * qz + qw * qw, min=1e-32))
  qx, qy, qz, qw = qx / qn, qy / qn, qz / qn, qw / qn
  xx, yy, zz = qx * qx, qy * qy, qz * qz
  R = ((1 - 2 * yy - 2 * zz, 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)),
       (2 * (qx * qy + qw * qz), 1 - 2 * xx - 2 * zz, 2 * (qy * qz - qw * qx)),
       (2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * xx - 2 * yy))
  s = (torch.exp(log_scaling[:, 0]), torch.exp(log_scaling[:, 1]),
       torch.exp(log_scaling[:, 2]))
  in_cam = [pxw * T[i, 0] + pyw * T[i, 1] + pzw * T[i, 2] + T[i, 3]
            for i in range(3)]
  z = in_cam[2]
  inv_z = 1.0 / z
  mx = fx * in_cam[0] * inv_z + cx
  my = fy * in_cam[1] * inv_z + cy
  tx = torch.clamp(mx, -w_size * clamp_margin, (w_size - 1) * (1 + clamp_margin))
  ty = torch.clamp(my, -h_size * clamp_margin, (h_size - 1) * (1 + clamp_margin))
  j00 = fx * inv_z
  j11 = fy * inv_z
  j02 = -(tx - cx) * inv_z
  j12 = -(ty - cy) * inv_z
  jw0 = [j00 * T[0, k] + j02 * T[2, k] for k in range(3)]
  jw1 = [j11 * T[1, k] + j12 * T[2, k] for k in range(3)]
  m0 = [(jw0[0] * R[0][l] + jw0[1] * R[1][l] + jw0[2] * R[2][l]) * s[l]
        for l in range(3)]
  m1 = [(jw1[0] * R[0][l] + jw1[1] * R[1][l] + jw1[2] * R[2][l]) * s[l]
        for l in range(3)]
  cov_a = m0[0] * m0[0] + m0[1] * m0[1] + m0[2] * m0[2] + blur_cov
  cov_b = m0[0] * m1[0] + m0[1] * m1[1] + m0[2] * m1[2]
  cov_c = m1[0] * m1[0] + m1[1] * m1[1] + m1[2] * m1[2] + blur_cov
  tr = cov_a + cov_c
  det = cov_a * cov_c - cov_b * cov_b
  gap_floor = 1e-12 * tr * tr + 1e-36
  sqrt_gap = torch.sqrt(torch.maximum(tr * tr - 4 * det, gap_floor))
  lam1 = (tr + sqrt_gap) * 0.5
  lam2 = (tr - sqrt_gap) * 0.5
  c1x, c1y = cov_a - lam2, cov_b
  c2x, c2y = cov_b, cov_c - lam2
  n1 = c1x * c1x + c1y * c1y
  n2 = c2x * c2x + c2y * c2y
  pick1 = n1 >= n2
  vx = torch.where(pick1, c1x, c2x)
  vy = torch.where(pick1, c1y, c2y)
  iso = (n1 + n2) < 1e-30
  vx = torch.where(iso, torch.ones_like(vx), vx)
  vy = torch.where(iso, torch.zeros_like(vy), vy)
  vn = torch.sqrt(torch.clamp(vx * vx + vy * vy, min=1e-32))
  ax = vx / vn
  ay = vy / vn
  sig1 = torch.sqrt(torch.clamp(lam1, min=0.0))
  sig2 = torch.sqrt(torch.clamp(lam2, min=0.0))
  alpha = torch.sigmoid(alpha_logit[:, 0])
  alpha_c = alpha.detach()
  gs = gaussian_scale_factor(alpha_c, alpha_threshold)
  r0 = sig1.detach() * gs
  r1 = sig2.detach() * gs
  ax_c, ay_c = ax.detach(), ay.detach()
  ext_x = torch.sqrt((ax_c * r0) ** 2 + (ay_c * r1) ** 2)
  ext_y = torch.sqrt((ay_c * r0) ** 2 + (ax_c * r1) ** 2)
  mx_c, my_c, z_c = mx.detach(), my.detach(), z.detach()
  near, far = depth_range
  in_view = ((z_c > near) & (z_c < far)
             & (mx_c + ext_x > 0) & (my_c + ext_y > 0)
             & (mx_c - ext_x < w_size) & (my_c - ext_y < h_size)
             & (alpha_c > alpha_threshold))
  keepf = in_view.to(dtype)
  points = torch.stack(
      [mx * keepf, my * keepf, ax * keepf, ay * keepf,
       sig1 * keepf, sig2 * keepf, alpha * keepf], dim=-1)
  depth = (z * keepf)[:, None]
  return points, depth, in_view


# -- frozen: ops/sh.py -------------------------------------------------------


def rsh_cart(xyz: torch.Tensor, degree: int) -> torch.Tensor:
  x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
  out = [torch.full_like(x, 0.282094791773878)]
  if degree >= 1:
    out += [-0.48860251190292 * y, 0.48860251190292 * z, -0.48860251190292 * x]
  if degree >= 2:
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    out += [1.09254843059208 * xy, -1.09254843059208 * yz,
            0.94617469575756 * z2 - 0.31539156525252, -1.09254843059208 * xz,
            0.54627421529604 * (x2 - y2)]
  if degree >= 3:
    out += [
        -0.590043589926644 * y * (3.0 * x2 - y2),
        2.89061144264055 * xy * z,
        0.304697199642977 * y * (1.5 - 7.5 * z2),
        1.24392110863372 * z * (1.5 * z2 - 0.5) - 0.497568443453487 * z,
        0.304697199642977 * x * (1.5 - 7.5 * z2),
        1.44530572132028 * z * (x2 - y2),
        -0.590043589926644 * x * (x2 - 3.0 * y2),
    ]
  return torch.stack(out, dim=-1)


class _Tf32ShContract(torch.autograd.Function):
  """sum_k sh[n, c, k] basis[n, k] with TF32 operands (the basis takes no
  gradient: it is shaded at detached positions)."""

  @staticmethod
  def forward(ctx, sh, basis):
    rb = round_tf32(basis)
    ctx.save_for_backward(rb)
    return (round_tf32(sh) * rb[:, None, :]).sum(-1)

  @staticmethod
  def backward(ctx, g):
    rb, = ctx.saved_tensors
    return round_tf32(g)[:, :, None] * rb[:, None, :], None


def evaluate_sh_at(sh_params, positions, camera_pos, tf32: bool = False):
  n_sh = sh_params.shape[2]
  degree = int(math.isqrt(n_sh)) - 1
  v = positions - camera_pos
  sq = torch.sum(v * v, dim=-1, keepdim=True)
  ok = sq > 1e-32
  sq = torch.where(ok, sq, torch.ones_like(sq))
  view_dir = torch.where(ok, v / torch.sqrt(sq), torch.zeros_like(v))
  basis = rsh_cart(view_dir, degree)
  if tf32:
    color = _Tf32ShContract.apply(sh_params, basis.detach())
  else:
    color = torch.einsum("nck,nk->nc", sh_params, basis)
  return torch.clamp(color + 0.5, 0.0, 1.0)


# -- frozen: ops/mapper.py (64-bit keys) -------------------------------------


def _cdiv(a: int, b: int) -> int:
  return -(-a // b)


def map_to_tiles(points: torch.Tensor, depth: torch.Tensor,
                 image_size: Tuple[int, int], tile_size: int,
                 alpha_threshold: float, max_span: int) -> Dict:
  """Each tile's points, front to back: dict(otp (K,) int64 point ids of
  the real overlaps, ranges (T, 2) int64 [start, end) per tile,
  tile_shape (th, tw), overflow () bool)."""
  n = points.shape[0]
  device = points.device
  w, h = image_size
  tw, th = _cdiv(int(w), tile_size), _cdiv(int(h), tile_size)
  n_tiles = tw * th
  mx, my = points[:, 0], points[:, 1]
  ax, ay = points[:, 2], points[:, 3]
  sx, sy = points[:, 4], points[:, 5]
  alpha = points[:, 6]
  valid = alpha > alpha_threshold
  gs = gaussian_scale_factor(alpha, alpha_threshold)
  r0 = torch.clamp(sx * gs, min=1e-12)
  r1 = torch.clamp(sy * gs, min=1e-12)
  ext_x = torch.sqrt((ax * r0) ** 2 + (ay * r1) ** 2)
  ext_y = torch.sqrt((ay * r0) ** 2 + (ax * r1) ** 2)

  def axis_range(m, ext, nt):
    lo = torch.clamp(torch.floor((m - ext) / tile_size), 0, nt - 1).to(torch.int32)
    hi = torch.clamp(torch.ceil((m + ext) / tile_size), 0, nt).to(torch.int32)
    hi = torch.clamp(torch.maximum(hi, lo + 1), max=nt)
    return lo, hi

  tx0, tx1 = axis_range(mx, ext_x, tw)
  ty0, ty1 = axis_range(my, ext_y, th)
  zero = torch.zeros_like(tx0)
  raw_x = torch.where(valid, tx1 - tx0, zero)
  raw_y = torch.where(valid, ty1 - ty0, zero)
  overflow = torch.any(raw_x > max_span) | torch.any(raw_y > max_span)
  span_x = torch.clamp(raw_x, 0, max_span)
  span_y = torch.clamp(raw_y, 0, max_span)
  ib = (ax / r0, ay / r0, -ay / r1, ax / r1)

  counts = (span_x * span_y).to(torch.int64)
  offsets = torch.cumsum(counts, 0) - counts
  n_cand = int(counts.sum())
  gid = torch.repeat_interleave(torch.arange(n, device=device), counts,
                                output_size=n_cand)
  j = torch.arange(n_cand, device=device) - offsets[gid]
  sxg = span_x.to(torch.int64)[gid]
  ty = ty0[gid] + j // sxg
  tx = tx0[gid] + j % sxg
  lo_x = (tx * tile_size).to(points.dtype) - mx[gid]
  lo_y = (ty * tile_size).to(points.dtype) - my[gid]
  hi_x, hi_y = lo_x + tile_size, lo_y + tile_size
  sep = None
  for bx, by in ((ib[0][gid], ib[1][gid]), (ib[2][gid], ib[3][gid])):
    mn = torch.minimum(bx * lo_x, bx * hi_x) + torch.minimum(by * lo_y, by * hi_y)
    mxv = torch.maximum(bx * lo_x, bx * hi_x) + torch.maximum(by * lo_y, by * hi_y)
    s = (mn > 1.0) | (mxv < -1.0)
    sep = s if sep is None else (sep | s)
  tile = torch.where(~sep, (tx + ty * tw).to(torch.int64), n_tiles)
  depth_rank = torch.empty(n, dtype=torch.int64, device=device)
  depth_rank[torch.sort(depth, stable=True).indices] = torch.arange(n, device=device)
  key, order = torch.sort((tile << 32) | depth_rank[gid], stable=True)
  sorted_tile = key >> 32
  bounds = torch.searchsorted(
      sorted_tile, torch.arange(n_tiles + 1, dtype=torch.int64, device=device))
  total = int(bounds[-1])
  return dict(otp=gid[order][:total], ranges=torch.stack([bounds[:-1], bounds[1:]], 1),
              tile_shape=(th, tw), overflow=overflow)


# -- the blend, in blocks of tiles -------------------------------------------


def _tile_geometry(tiles: torch.Tensor, tw: int, ts: int, dtype):
  return ((tiles % tw) * ts).to(dtype), ((tiles // tw) * ts).to(dtype)


def _pixel_centres(ts: int, device, dtype):
  lin = torch.arange(ts * ts, device=device)
  return (lin % ts).to(dtype) + 0.5, (lin // ts).to(dtype) + 0.5


def inside_mask(tile_shape, ts: int, image_size, device) -> torch.Tensor:
  """(T, P) bool: the tile's pixel lies inside the image."""
  th, tw = tile_shape
  w, h = image_size
  t = torch.arange(th * tw, device=device)
  lin = torch.arange(ts * ts, device=device)
  x = (t % tw)[:, None] * ts + (lin % ts)[None, :]
  y = (t // tw)[:, None] * ts + (lin // ts)[None, :]
  return (x < w) & (y < h)


def _chunk(pts, fts, live, ox, oy, cx, cy, t_carry, rc, tf32):
  """One chunk of slots of a block of tiles. pts (B, S, 7), fts (B, S, F),
  live (B, S), tile origins (B,), pixel centres (P,), the transmittance
  carried in (B, P). Returns (image part (B, P, F), weight part (B, P),
  transmittance out (B, P), gate open before each slot (B, P, S), alpha
  over the threshold (B, P, S))."""
  mx = (pts[..., 0] - ox[:, None])[:, None, :]
  my = (pts[..., 1] - oy[:, None])[:, None, :]
  ax, ay = pts[..., 2][:, None, :], pts[..., 3][:, None, :]
  sx, sy = pts[..., 4][:, None, :], pts[..., 5][:, None, :]
  pa = pts[..., 6][:, None, :]
  dx = cx[None, :, None] - mx
  dy = cy[None, :, None] - my
  isx2 = 1.0 / (sx * sx)
  isy2 = 1.0 / (sy * sy)
  qa = ax * ax * isx2 + ay * ay * isy2
  qb = ax * ay * (isx2 - isy2)
  qc = ay * ay * isx2 + ax * ax * isy2
  # the port's log(max(pa, 0)) floored at -1e4, with the floor taken on pa
  # (1e-30, below any alpha a bin holds) so that the no-op sentinel's
  # gradient is 0 and not 0 * inf
  log_pa = torch.log(torch.clamp(pa, min=1e-30))
  a_raw = torch.exp(log_pa - 0.5 * (qa * dx * dx + 2.0 * qb * dx * dy + qc * dy * dy))
  thresh = (a_raw > rc["alpha_threshold"]) & live[:, None, :]
  a_eff = torch.where(thresh, torch.clamp(a_raw, max=rc["clamp_max_alpha"]),
                      torch.zeros_like(a_raw))
  t_incl = t_carry[..., None] * torch.cumprod(1 - a_eff, dim=-1)
  t_excl = torch.cat([t_carry[..., None], t_incl[..., :-1]], dim=-1)
  open_ = (1 - t_excl) < rc["saturate_threshold"]
  w = a_eff * t_excl * open_
  return bmm(w, fts, tf32), w.sum(-1), t_incl[..., -1], open_, thresh


def _gather(points, feats, otp, starts, ends, c0: int, width: int):
  """The slots [c0, c0 + width) of each tile's bin: (pts (B, S, 7), fts
  (B, S, F), live (B, S), point ids (B, S)); slots past a bin take a
  no-op sentinel point."""
  slot = starts[:, None] + c0 + torch.arange(width, device=starts.device)
  live = slot < ends[:, None]
  k = otp.shape[0]
  idx = torch.where(live, otp[slot.clamp(max=max(k - 1, 0))], 0) if k \
      else torch.zeros_like(slot)
  sentinel = points.new_tensor(SENTINEL_ROW)
  pts = torch.where(live[..., None], points[idx], sentinel)
  fts = torch.where(live[..., None], feats[idx], 0.0)
  return pts, fts, live, idx


def raster_forward(points: torch.Tensor, feats: torch.Tensor, mapping: Dict,
                   image_size, rc: Dict, tf32: bool = False):
  """The blend of a frame. Returns dict(image (H, W, F), weight (H, W),
  walked (T,) int64: the slots each tile's walk took, up to its
  saturation or its bin's end, whole chunks; active: the (pixel, slot)
  pairs inside the image, within a pixel's open gate, whose alpha passes
  the threshold)."""
  device, dtype = points.device, points.dtype
  ts = rc["tile_size"]
  th, tw = mapping["tile_shape"]
  n_t, p, f = th * tw, ts * ts, feats.shape[1]
  starts, ends = mapping["ranges"][:, 0], mapping["ranges"][:, 1]
  lens = ends - starts
  inside = inside_mask((th, tw), ts, image_size, device)
  cx, cy = _pixel_centres(ts, device, dtype)
  img_t = points.new_zeros(n_t, p, f)
  wgt_t = points.new_zeros(n_t, p)
  walked = torch.zeros(n_t, dtype=torch.int64, device=device)
  active = torch.zeros((), dtype=torch.int64, device=device)
  order = torch.argsort(lens, descending=True)
  order = order[lens[order] > 0]
  block = max(1, BLOCK_ELEMENTS // (p * CHUNK))
  with torch.no_grad(), no_tf32():
    for b0 in range(0, order.shape[0], block):
      tiles = order[b0:b0 + block]
      pos = torch.arange(tiles.shape[0], device=device)
      img_b = points.new_zeros(tiles.shape[0], p, f)
      wgt_b = points.new_zeros(tiles.shape[0], p)
      t_carry = points.new_ones(tiles.shape[0], p)
      cur, c0 = tiles, 0
      while cur.shape[0]:
        ox, oy = _tile_geometry(cur, tw, ts, dtype)
        pts, fts, live, _ = _gather(points, feats, mapping["otp"], starts[cur],
                                    ends[cur], c0, CHUNK)
        img_c, wgt_c, t_carry, open_, thresh = _chunk(
            pts, fts, live, ox, oy, cx, cy, t_carry, rc, tf32)
        img_b.index_add_(0, pos, img_c)
        wgt_b.index_add_(0, pos, wgt_c)
        active += (open_ & thresh & inside[cur][:, :, None]).sum()
        c0 += CHUNK
        walked[cur] = torch.clamp(lens[cur], max=c0)
        done = (((1 - t_carry) >= rc["saturate_threshold"]) | ~inside[cur]).all(-1) \
            | (lens[cur] <= c0)
        keep = ~done
        cur, pos, t_carry = cur[keep], pos[keep], t_carry[keep]
      img_t[tiles] = img_b
      wgt_t[tiles] = wgt_b
  return dict(image=tiles_to_image(img_t, (th, tw), ts, image_size),
              weight=tiles_to_image(wgt_t[..., None], (th, tw), ts, image_size)[..., 0],
              walked=walked, active=int(active))


def tiles_to_image(tiled, tile_shape, ts, image_size):
  """(T, P, C) -> (H, W, C)."""
  th, tw = tile_shape
  c = tiled.shape[-1]
  img = tiled.reshape(th, tw, ts, ts, c).permute(0, 2, 1, 3, 4)
  w, h = image_size
  return img.reshape(th * ts, tw * ts, c)[:h, :w]


def image_to_tiles(image, tile_shape, ts):
  """(H, W, C) -> (T, P, C), zero-padded."""
  th, tw = tile_shape
  h, w, c = image.shape
  image = torch.nn.functional.pad(image, (0, 0, 0, tw * ts - w, 0, th * ts - h))
  return image.reshape(th, ts, tw, ts, c).permute(0, 2, 1, 3, 4).reshape(
      th * tw, ts * ts, c)


def raster_vjp(points: torch.Tensor, feats: torch.Tensor, mapping: Dict,
               image_size, rc: Dict, walked: torch.Tensor,
               grad_image: torch.Tensor, grad_weight: torch.Tensor,
               tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
  """The blend's gradient: (d/d points (N, 7), d/d feats (N, F)) for the
  cotangents (H, W, F) and (H, W), by autograd over each tile's walked
  slots (`raster_forward`'s `walked`), in blocks of tiles of similar
  walks."""
  device, dtype = points.device, points.dtype
  ts = rc["tile_size"]
  th, tw = mapping["tile_shape"]
  p, f = ts * ts, feats.shape[1]
  starts, ends = mapping["ranges"][:, 0], mapping["ranges"][:, 1]
  cx, cy = _pixel_centres(ts, device, dtype)
  g_img_t = image_to_tiles(grad_image, (th, tw), ts)
  g_wgt_t = image_to_tiles(grad_weight[..., None], (th, tw), ts)[..., 0]
  g_points = torch.zeros_like(points)
  g_feats = torch.zeros_like(feats)
  order = torch.argsort(walked, descending=True)
  order = order[walked[order] > 0]
  lengths = walked[order].tolist()
  i = 0
  with no_tf32():
    while i < len(lengths):
      width = _cdiv(lengths[i], CHUNK) * CHUNK
      block = max(1, BLOCK_ELEMENTS // (p * width))
      tiles = order[i:i + block]
      i += block
      pts, fts, live, idx = _gather(points.detach(), feats.detach(),
                                    mapping["otp"], starts[tiles], ends[tiles],
                                    0, width)
      pts.requires_grad_()
      fts.requires_grad_()
      ox, oy = _tile_geometry(tiles, tw, ts, dtype)
      t_carry = points.new_ones(tiles.shape[0], p)
      img, wgt = 0.0, 0.0
      for c0 in range(0, width, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        img_c, wgt_c, t_carry, _, _ = _chunk(
            pts[:, sl], fts[:, sl], live[:, sl], ox, oy, cx, cy, t_carry, rc, tf32)
        img, wgt = img + img_c, wgt + wgt_c
      torch.autograd.backward([img, wgt], [g_img_t[tiles], g_wgt_t[tiles]])
      flat = idx.reshape(-1)
      g_points.index_add_(0, flat, pts.grad.reshape(-1, 7))
      g_feats.index_add_(0, flat, fts.grad.reshape(-1, f))
  return g_points, g_feats


# -- a render and a training step --------------------------------------------


def raster_config(cfg: Dict) -> Dict:
  """The configuration's RasterConfig fields the reference needs (the
  port's defaults where the file names none)."""
  rc = dict(tile_size=16, alpha_threshold=1.0 / 255.0, clamp_max_alpha=0.99,
            saturate_threshold=0.9999, blur_cov=0.3, clamp_margin=0.15,
            max_tile_span=16)
  rc.update(cfg.get("raster_config", {}))
  return rc


def render(gaussians: Dict, camera: Dict, cfg: Dict, tf32: bool = False) -> Dict:
  """The frame of `gaussians` under `camera`: dict(image (H, W, C) the
  feature channels, depth (H, W) when the configuration renders depth,
  weight (H, W), and what the gradient needs: points, feats, mapping,
  walked, active). Differentiable up to points and feats."""
  rc = raster_config(cfg)
  near, far = camera["near_plane"], camera["far_plane"]
  size = tuple(camera["image_size"])
  with no_tf32():
    points, depth, _ = project_points(
        gaussians["position"], gaussians["log_scaling"], gaussians["rotation"],
        gaussians["alpha_logit"], camera["T_camera_world"], camera["projection"],
        size, (near, far), blur_cov=rc["blur_cov"],
        clamp_margin=rc["clamp_margin"], alpha_threshold=rc["alpha_threshold"])
    if cfg["features"]["kind"] == "sh":
      colors = evaluate_sh_at(gaussians["feature"], gaussians["position"].detach(),
                              camera_position(camera["T_camera_world"]), tf32)
    else:
      colors = gaussians["feature"]
    feats = torch.cat([depth, depth * depth, colors], 1) if cfg["render_depth"] \
        else colors
    ndc = ndc_depth(torch.clamp(depth.detach(), min=near), near, far)[:, 0]
    mapping = map_to_tiles(points.detach(), ndc, size, rc["tile_size"],
                           rc["alpha_threshold"], rc["max_tile_span"])
  out = raster_forward(points.detach(), feats.detach().contiguous(), mapping,
                       size, rc, tf32)
  image = out["image"]
  depth_img = None
  if cfg["render_depth"]:
    depth_img = image[..., 0] / (out["weight"] + 1e-6)
    image = image[..., 2:]
  return dict(image=image, depth=depth_img, weight=out["weight"],
              raw_image=out["image"], points=points, feats=feats,
              mapping=mapping, walked=out["walked"], active=out["active"],
              rc=rc, size=size)


def loss_and_grads(gaussians: Dict, camera: Dict, cfg: Dict, loss: Callable,
                   target: torch.Tensor, tf32: bool = False,
                   rows: Optional[slice] = None):
  """(loss, {key: gradient}) of one camera's loss(image, depth, target)
  at `gaussians` (a plain torch function of `splatbench/losses/`); with
  `rows`, the loss of those image rows alone."""
  leaves = {k: v.detach().requires_grad_() for k, v in gaussians.items()}
  r = render(leaves, camera, cfg, tf32)
  raw = r["raw_image"].detach().requires_grad_()
  wgt = r["weight"].detach().requires_grad_()
  if cfg["render_depth"]:
    image, depth = raw[..., 2:], raw[..., 0] / (wgt + 1e-6)
  else:
    image, depth = raw, None
  if rows is not None:
    image, target = image[rows], target[rows]
    depth = None if depth is None else depth[rows]
  value = loss(image, depth, target)
  g_raw, g_wgt = torch.autograd.grad(value, [raw, wgt], allow_unused=True)
  g_wgt = torch.zeros_like(wgt) if g_wgt is None else g_wgt
  g_pts, g_fts = raster_vjp(r["points"].detach(), r["feats"].detach(), r["mapping"],
                            r["size"], r["rc"], r["walked"], g_raw.contiguous(),
                            g_wgt.contiguous(), tf32)
  with no_tf32():
    torch.autograd.backward([r["points"], r["feats"]], [g_pts, g_fts])
  grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
           for k, v in leaves.items()}
  return value.detach(), grads


class FractionalAdam:
  """The port's FractionalAdam with unit weights on scalar groups: every
  point steps each time, with the step damped by 1 - exp(-2)."""

  def __init__(self, params: Dict, lrs: Dict, betas=(0.9, 0.999), eps=1e-16):
    self.params = {k: v.detach().clone() for k, v in params.items()}
    self.lrs, self.betas, self.eps = lrs, betas, eps
    self.m = {k: torch.zeros_like(v) for k, v in params.items()}
    self.v = {k: torch.zeros_like(v) for k, v in params.items()}
    self.t = 0

  def step(self, grads: Dict) -> None:
    b1, b2 = self.betas
    self.t += 1
    bias1, bias2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
    damp = 1.0 - math.exp(-2.0)
    for k, p in self.params.items():
      if k not in self.lrs:
        continue
      g = grads[k].to(torch.float32)
      self.m[k] = self.m[k] * b1 + g * (1.0 - b1)
      self.v[k] = self.v[k] * b2 + g * g * (1.0 - b2)
      lr_step = self.m[k] / torch.clamp(torch.sqrt(self.v[k]), min=self.eps) \
          * (math.sqrt(bias2) / bias1)
      p -= (lr_step * damp * self.lrs[k]).to(p.dtype)
