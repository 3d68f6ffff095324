"""Numpy scenes shared by the tests that hold the PyTorch port against the
JAX package: the same arrays, made from a seed, go through both.

JAX is imported only by `jax_scene`, so the tests that run on a machine
with a GPU and no JAX (tests/test_torch_cuda.py) can use the scenes too.
"""

import numpy as np
import torch

from taichi_gaussian_rasterizer_tpu_torch import convert

TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _quat_to_mat(q):
  x, y, z, w = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def camera(seed, image_size):
  """A camera with a random pose looking along its +z, as numpy arrays."""
  rng = np.random.default_rng(seed)
  q = rng.normal(size=4)
  R = _quat_to_mat(q / np.linalg.norm(q))
  t = rng.normal(size=3)
  T = np.eye(4)
  T[:3, :3] = R.T
  T[:3, 3] = -R.T @ t
  w, h = image_size
  f = w / (2 * np.tan(np.deg2rad(rng.uniform(40, 90)) / 2))
  c = np.array([w / 2, h / 2]) + rng.normal(size=2) * w / 40
  return dict(projection=np.array([f, f, c[0], c[1]]), T_camera_world=T,
              near=0.1, far=100.0, image_size=tuple(image_size))


def gaussians3d(seed, n, cam, scale_factor=1.0, alpha_range=(0.1, 0.9),
                sh_degree=None, margin=0.1):
  """Gaussians unprojected from uniform uv, widened by `margin` of the image
  on every side, at depths 1-20 in front of `cam`."""
  rng = np.random.default_rng(seed)
  w, h = cam["image_size"]
  fx, fy, cx, cy = cam["projection"]
  uv = (rng.uniform(size=(n, 2)) * (1 + 2 * margin) - margin) * [w, h]
  z = rng.uniform(1.0, 20.0, size=n)
  cam_xyz = np.stack([(uv[:, 0] - cx) * z / fx, (uv[:, 1] - cy) * z / fy, z], 1)
  T = cam["T_camera_world"]
  position = (cam_xyz - T[:3, 3]) @ T[:3, :3]
  scale = (w / np.sqrt(n)) * z / fx * scale_factor
  q = rng.normal(size=(n, 4))
  alpha = rng.uniform(*alpha_range, size=n)
  if sh_degree is None:
    feature = rng.uniform(size=(n, 3))
  else:
    feature = rng.uniform(size=(n, 3, (sh_degree + 1) ** 2)) - 0.5
  return dict(
      position=position,
      log_scaling=np.log((rng.uniform(size=(n, 3)) + 0.2) * scale[:, None]),
      rotation=q / np.linalg.norm(q, axis=1, keepdims=True),
      alpha_logit=np.log(alpha / (1 - alpha))[:, None],
      feature=feature)


def points2d(seed, n, image_size, sigma_range=(0.8, 4.0),
             alpha_range=(0.1, 0.9), n_features=3):
  """Packed 2D gaussians (N, 7), distinct depths (N,) and features (N, F)."""
  rng = np.random.default_rng(seed)
  w, h = image_size
  mean = rng.uniform(size=(n, 2)) * [w + 8, h + 8] - 4
  theta = rng.uniform(0, np.pi, size=n)
  sigma = np.sort(rng.uniform(*sigma_range, size=(n, 2)), axis=1)[:, ::-1]
  alpha = rng.uniform(*alpha_range, size=n)
  points = np.concatenate(
      [mean, np.cos(theta)[:, None], np.sin(theta)[:, None], sigma,
       alpha[:, None]], axis=1)
  depth = rng.permutation(n) / n + 0.1
  return points, depth, rng.uniform(size=(n, n_features))


def gaussians2d(seed, n, image_size, scale_factor=1.0, alpha_range=(0.3, 0.9),
                n_features=3):
  """Gaussians2D fields as numpy arrays: uniform positions over the image,
  distinct depths in (0, 1), scales ~ width / sqrt(n), unit rotations."""
  rng = np.random.default_rng(seed)
  w, h = image_size
  rot = rng.normal(size=(n, 2))
  alpha = rng.uniform(*alpha_range, size=n)
  scale = scale_factor * w / (1 + np.sqrt(n))
  return dict(
      position=rng.uniform(size=(n, 2)) * [w, h],
      z_depth=(rng.permutation(n)[:, None] + 0.5) / n,
      log_scaling=np.log((rng.uniform(size=(n, 2)) + 0.2) * scale),
      rotation=rot / np.linalg.norm(rot, axis=1, keepdims=True),
      alpha_logit=np.log(alpha / (1 - alpha))[:, None],
      feature=rng.uniform(size=(n, n_features)))


def jax_scene(cam, g, dtype):
  import jax.numpy as jnp
  import taichi_gaussian_rasterizer_tpu as tgr_jax

  jcam = tgr_jax.CameraParams(
      projection=jnp.asarray(cam["projection"], dtype),
      T_camera_world=jnp.asarray(cam["T_camera_world"], dtype),
      near_plane=cam["near"], far_plane=cam["far"],
      image_size=cam["image_size"])
  jg = tgr_jax.Gaussians3D(**{k: jnp.asarray(v, dtype) for k, v in g.items()})
  return jg, jcam


def torch_scene(cam, g, dtype):
  tdtype = TORCH_DTYPE[dtype]
  return (convert.gaussians_from_numpy(**g, device="cpu", dtype=tdtype),
          convert.camera_from_numpy(cam["projection"], cam["T_camera_world"],
                                    cam["near"], cam["far"], cam["image_size"],
                                    device="cpu", dtype=tdtype))


def to_torch(x, dtype=None):
  """numpy -> CPU tensor (keeping the dtype unless one is given)."""
  x = torch.as_tensor(np.asarray(x))
  return x if dtype is None else x.to(TORCH_DTYPE[dtype])


def to_numpy(x):
  """JAX array or tensor -> numpy."""
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
