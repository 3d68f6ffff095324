"""Seeded scenes, cameras and camera paths, made on the device.

Frozen copies, so that the yardstick does not move when the program does:

* `random_camera`, `random_3d_gaussians`, `trained_like_gaussians` and
  `unproject_points` are copied from
  `taichi_gaussian_rasterizer_tpu_torch/utils/random_data.py` at commit
  7e9dc73bdb561296269ff5d4d0e4f9081da37a53, with the helpers they call
  from `taichi_gaussian_rasterizer_tpu_torch/ops/lib.py` (same commit).
  They return plain dicts of tensors instead of the port's dataclasses.
  Given the same `torch.Generator` they draw the same numbers as the
  originals (`tests/test_splatbench_reference.py` holds them equal).

* `make_scene`, `camera_path` and `derive_seed` are the benchmark's own;
  `make_scene` takes the geometry from the configuration's recipe,
  `splatbench/recipes/<recipe>.py`.

Imports torch only (and the benchmark's own recipes): nothing of the port
and nothing of JAX.
"""

import math
from typing import Dict, List, Optional, Tuple

import torch

GAUSSIAN_KEYS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


def derive_seed(seed: int, *labels: int) -> int:
  """A 63-bit seed for one stream of a run (scene, path, targets, ...),
  fixed by --seed and the stream's labels."""
  h = int(seed) & ((1 << 64) - 1)
  for label in labels:
    h = (h * 6364136223846793005 + 1442695040888963407 + int(label)) & ((1 << 64) - 1)
    h ^= h >> 29
  return h & ((1 << 63) - 1)


def generator(seed: int, device) -> torch.Generator:
  return torch.Generator(device=device).manual_seed(seed)


# -- frozen from ops/lib.py -------------------------------------------------


def safe_normalize(v, eps=1e-32):
  sq = torch.sum(v * v, dim=-1, keepdim=True)
  ok = sq > eps
  sq = torch.where(ok, sq, torch.ones_like(sq))
  return torch.where(ok, v / torch.sqrt(sq), torch.zeros_like(v))


def quat_to_mat(q):
  x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  x2, y2, z2 = x * x, y * y, z * z
  rows = [
      [1 - 2 * y2 - 2 * z2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
      [2 * x * y + 2 * w * z, 1 - 2 * x2 - 2 * z2, 2 * y * z - 2 * w * x],
      [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x2 - 2 * y2],
  ]
  return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def join_rt(r, t):
  top = torch.cat([r, t[..., :, None]], dim=-1)
  bottom = torch.tensor([0, 0, 0, 1], dtype=top.dtype, device=top.device)
  bottom = bottom.expand(top.shape[:-2] + (1, 4))
  return torch.cat([top, bottom], dim=-2)


def split_rt(rt):
  return rt[..., :3, :3], rt[..., :3, 3]


def inverse_sigmoid(x):
  return -torch.log(1.0 / x - 1.0)


def inverse_ndc_depth(ndc, near, far):
  return 1.0 / ((1.0 - ndc) * (1.0 / near - 1.0 / far) + 1.0 / far)


# -- frozen from utils/random_data.py ---------------------------------------


def _rand(gen, *shape, dtype):
  return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _randn(gen, *shape, dtype):
  return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def unproject_points(uv, depth, camera: Dict):
  fx, fy, cx, cy = (camera["projection"][i] for i in range(4))
  cam_xyz = torch.cat([(uv[..., 0:1] - cx) * depth / fx,
                       (uv[..., 1:2] - cy) * depth / fy, depth], dim=-1)
  R, t = split_rt(camera["T_camera_world"])
  d = cam_xyz - t
  return torch.stack(
      [d[..., 0] * R[0, i] + d[..., 1] * R[1, i] + d[..., 2] * R[2, i]
       for i in range(3)], dim=-1)


def random_camera(generator: torch.Generator, pos_scale: float = 1.0,
                  image_size: Optional[Tuple[int, int]] = None,
                  image_size_range: Tuple[int, int] = (256, 1024),
                  near_plane: float = 0.1, dtype=torch.float32) -> Dict:
  """A camera dict: projection (4,), T_camera_world (4, 4), near_plane,
  far_plane, image_size (width, height)."""
  q = safe_normalize(_randn(generator, 4, dtype=dtype))
  t = _randn(generator, 3, dtype=dtype) * pos_scale
  R = quat_to_mat(q)
  rt_t = torch.stack(
      [R[0, i] * t[0] + R[1, i] * t[1] + R[2, i] * t[2] for i in range(3)])
  T_camera_world = join_rt(R.T, -rt_t)

  if image_size is None:
    lo, hi = image_size_range
    image_size = tuple(int(x) for x in torch.randint(
        lo, hi, (2,), generator=generator, device=generator.device))
  w, h = image_size
  c = (torch.tensor([w / 2, h / 2], dtype=dtype, device=generator.device)
       + _randn(generator, 2, dtype=dtype) * (w / 20))
  fov = torch.deg2rad(_rand(generator, dtype=dtype) * 70 + 30)
  f = w / (2 * torch.tan(fov / 2))
  return dict(projection=torch.stack([f, f, c[0], c[1]]),
              T_camera_world=T_camera_world, near_plane=near_plane,
              far_plane=near_plane * 1000.0, image_size=(w, h))


def random_3d_gaussians(generator: torch.Generator, n: int, camera: Dict,
                        scale_factor: float = 1.0, alpha_range=(0.1, 0.9),
                        margin: float = 0.0, sh_degree: Optional[int] = None,
                        dtype=torch.float32) -> Dict[str, torch.Tensor]:
  w, h = camera["image_size"]
  size = torch.tensor([w, h], dtype=dtype, device=generator.device)
  uv = (_rand(generator, n, 2, dtype=dtype) * (1 + margin) - margin * 0.5) * size
  depth = inverse_ndc_depth(_rand(generator, n, dtype=dtype),
                            camera["near_plane"], camera["far_plane"])
  position = unproject_points(uv, depth[:, None], camera)
  fx = camera["projection"][0]

  scale = (w / math.sqrt(max(n, 1))) * (depth / fx) * scale_factor
  scaling = (_rand(generator, n, 3, dtype=dtype) + 0.2) * scale[:, None]
  rotation = safe_normalize(_randn(generator, n, 4, dtype=dtype))

  low, high = alpha_range
  alpha = _rand(generator, n, dtype=dtype) * (high - low) + low

  if sh_degree is None:
    feature = _rand(generator, n, 3, dtype=dtype)
  else:
    feature = _rand(generator, n, 3, (sh_degree + 1) ** 2, dtype=dtype) - 0.5
  return dict(position=position, log_scaling=torch.log(scaling),
              rotation=rotation, alpha_logit=inverse_sigmoid(alpha)[:, None],
              feature=feature)


def trained_like_gaussians(generator: torch.Generator, n: int, camera: Dict,
                           surface_frac: float = 0.8,
                           dtype=torch.float32) -> Dict[str, torch.Tensor]:
  w, h = camera["image_size"]
  device = generator.device
  size = torch.tensor([w, h], dtype=dtype, device=device)
  n_surf = int(n * surface_frac)
  n_clusters = 48
  centers = _rand(generator, n_clusters, 2, dtype=dtype) * size
  cid = torch.randint(0, n_clusters, (n,), generator=generator, device=device)
  uv_cluster = centers[cid] + _randn(generator, n, 2, dtype=dtype) * (size * 0.04)
  uv_uniform = _rand(generator, n, 2, dtype=dtype) * size
  in_cluster = _rand(generator, n, dtype=dtype) < 0.6
  uv = torch.where(in_cluster[:, None], uv_cluster, uv_uniform)
  uv = torch.minimum(torch.clamp(uv, min=0.0), size - 1.0)

  is_surf = torch.arange(n, device=device) < n_surf
  ndc = _rand(generator, n, dtype=dtype)
  ndc = torch.where(is_surf, ndc ** 1.5 * 0.6 + 0.05, 0.7 + 0.3 * ndc)
  depth = inverse_ndc_depth(ndc, camera["near_plane"], camera["far_plane"])
  position = unproject_points(uv, depth[:, None], camera)

  fx = camera["projection"][0]
  base = (w / math.sqrt(max(n, 1))) * (depth / fx)
  size_mult = torch.exp(_randn(generator, n, dtype=dtype) * 0.8 + torch.where(
      is_surf, math.log(1.1), math.log(3.0)))
  aniso = torch.exp(_randn(generator, n, 3, dtype=dtype) * 0.5)
  scaling = base[:, None] * size_mult[:, None] * aniso

  rotation = safe_normalize(_randn(generator, n, 4, dtype=dtype))
  alpha_logit = _randn(generator, n, dtype=dtype) * 1.6 + 1.8
  return dict(position=position, log_scaling=torch.log(scaling),
              rotation=rotation, alpha_logit=alpha_logit[:, None],
              feature=_rand(generator, n, 3, dtype=dtype))


# -- the benchmark's own -----------------------------------------------------


def make_scene(cfg: Dict, seed: int, device, root=None) -> Tuple[Dict, Dict]:
  """(camera, gaussians) of a configuration: the generating camera and the
  scene's geometry by the configuration's recipe
  (`<root>/splatbench/recipes/<recipe>.py`), drawn from its fixed
  `geometry_seed`, so that every run does the same work; then the
  features (SH coefficients or raw channels) from --seed."""
  from splatbench import harness
  gen = generator(derive_seed(cfg["geometry_seed"], 1), device)
  camera = random_camera(gen, image_size=tuple(cfg["image_size"]))
  scene = cfg["scene"]
  recipe = harness.load_part("recipes", scene["recipe"], root or harness.ROOT)
  g = recipe.make(gen, scene["points"], camera)
  feat = cfg["features"]
  fgen = generator(derive_seed(seed, 2), device)
  n = scene["points"]
  if feat["kind"] == "sh":
    # DC terms in [-0.5, 0.5), the higher bands scaled down, as a trained
    # scene's are: the shaded colours stay mostly inside [0, 1]
    k = (feat["sh_degree"] + 1) ** 2
    sh = torch.rand((n, 3, k), generator=fgen, device=device) - 0.5
    sh[..., 1:] *= feat["sh_rest_scale"]
    g["feature"] = sh
  elif feat["kind"] == "raw":
    g["feature"] = torch.rand((n, feat["channels"]), generator=fgen, device=device)
  else:
    raise ValueError(f"unknown feature kind {feat['kind']!r}")
  return camera, g


def median_depth(gaussians: Dict, camera: Dict) -> float:
  """The median camera-space depth of the scene's points in front of the
  camera."""
  T = camera["T_camera_world"]
  z = gaussians["position"] @ T[2, :3] + T[2, 3]
  z = z[z > camera["near_plane"]]
  return float(z.median()) if z.numel() else 1.0


def _axis_rotation(axis: int, angle: torch.Tensor) -> torch.Tensor:
  c, s = torch.cos(angle), torch.sin(angle)
  one, zero = torch.ones_like(c), torch.zeros_like(c)
  if axis == 0:   # pitch, about the camera's x axis
    rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
  else:           # yaw, about the camera's y axis
    rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
  return torch.stack([torch.stack(r, -1) for r in rows], -2)


def camera_path(camera: Dict, views: int, max_angle_deg: float,
                shift: float, geometry_seed: int, seed: int) -> List[Dict]:
  """`views` cameras around the generating one, each rotated by a yaw and
  a pitch drawn within +-max_angle_deg and moved by a camera-space
  translation drawn within +-shift on each axis, from `geometry_seed`
  (the same set for every run), in an order drawn from --seed. Same
  intrinsics, clip range and image size."""
  T = camera["T_camera_world"]
  gen = generator(derive_seed(geometry_seed, 3), T.device)
  u = torch.rand((views, 5), generator=gen, device=T.device, dtype=T.dtype) * 2 - 1
  angle = math.radians(max_angle_deg)
  path = []
  for i in range(views):
    R = _axis_rotation(1, u[i, 0] * angle) @ _axis_rotation(0, u[i, 1] * angle)
    D = join_rt(R, u[i, 2:5] * shift)
    path.append(dict(camera, T_camera_world=(D @ T).contiguous()))
  order = torch.randperm(views, generator=torch.Generator().manual_seed(
      derive_seed(seed, 5)))
  return [path[i] for i in order.tolist()]
