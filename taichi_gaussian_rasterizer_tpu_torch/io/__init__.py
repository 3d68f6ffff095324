"""3DGS `.ply` checkpoints and the host-side primitives (port of
`taichi_gaussian_rasterizer_tpu.io`).

A `.ply` written by either package loads in the other: the same columns,
the same wxyz quaternions on disk, the same SH band layout and the same
stable Morton order on load.
"""

import numpy as np
import torch

from . import native
from .native import (full_cumsum, load_ply, morton3d, ply_info, radix_argsort,
                     radix_sort_pairs, segmented_sort_pairs)
from ..data_types import Gaussians3D


def load_gaussians_ply(path: str, morton_order: bool = True, device="cuda",
                       dtype=torch.float32) -> Gaussians3D:
  """Load a standard 3DGS `.ply` checkpoint into a Gaussians3D on
  `device` (the card unless the caller asks otherwise): positions, log
  scales, xyzw rotations, opacity logits and SH coefficients (N, 3, K),
  K = 1 + rest / 3. With morton_order the points are reordered along the
  Morton curve of their positions (`native.morton3d`, stable), on the
  device, for memory-coherent access."""
  data, names = load_ply(path)
  col = {name: i for i, name in enumerate(names)}
  data = torch.from_numpy(data).to(device)

  def cols(*keys):
    return data[:, [col[k] for k in keys]]

  position = cols("x", "y", "z")
  n_rest = sum(1 for name in names if name.startswith("f_rest_"))
  feature = torch.cat(
      [cols(*(f"f_dc_{i}" for i in range(3)))[:, :, None],
       cols(*(f"f_rest_{i}" for i in range(n_rest))).reshape(
           data.shape[0], 3, n_rest // 3)],
      dim=2)
  fields = dict(
      position=position,
      log_scaling=cols(*(f"scale_{i}" for i in range(3))),
      # 3DGS stores quaternions wxyz; the kernels take xyzw
      rotation=cols("rot_1", "rot_2", "rot_3", "rot_0"),
      alpha_logit=cols("opacity"),
      feature=feature)
  if morton_order:
    order = torch.sort(morton3d(position), stable=True).indices
    fields = {k: v[order] for k, v in fields.items()}
  return Gaussians3D(**{k: v.to(dtype).contiguous() for k, v in fields.items()})


def save_gaussians_ply(path: str, gaussians: Gaussians3D) -> None:
  """Write a Gaussians3D as a standard binary-LE 3DGS `.ply`: x/y/z,
  nx/ny/nz zeros, f_dc_*, f_rest_* (the SH bands past the first, channel
  by channel), opacity, scale_*, rot_* in wxyz order, all float32. Plain
  (N, 3) RGB features are written as a single DC band. The inverse of
  load_gaussians_ply."""
  def host(t):
    return t.detach().to("cpu", torch.float32).numpy()

  pos = host(gaussians.position)
  n = pos.shape[0]
  feat = host(gaussians.feature)
  if feat.ndim == 2:
    feat = feat[:, :, None]
  rest = feat[:, :, 1:].reshape(n, -1)
  rot = host(gaussians.rotation)[:, [3, 0, 1, 2]]          # xyzw -> wxyz
  scale = host(gaussians.log_scaling)
  zeros = np.zeros(n, np.float32)
  cols = [("x", pos[:, 0]), ("y", pos[:, 1]), ("z", pos[:, 2]),
          ("nx", zeros), ("ny", zeros), ("nz", zeros)]
  cols += [(f"f_dc_{i}", feat[:, i, 0]) for i in range(3)]
  cols += [(f"f_rest_{i}", rest[:, i]) for i in range(rest.shape[1])]
  cols += [("opacity", host(gaussians.alpha_logit)[:, 0])]
  cols += [(f"scale_{i}", scale[:, i]) for i in range(3)]
  cols += [(f"rot_{i}", rot[:, i]) for i in range(4)]

  header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
  header += [f"property float {name}" for name, _ in cols]
  header += ["end_header"]
  body = np.stack([c for _, c in cols], axis=1).astype("<f4")
  with open(path, "wb") as f:
    f.write(("\n".join(header) + "\n").encode())
    f.write(body.tobytes())


__all__ = ["native", "full_cumsum", "load_ply", "morton3d", "ply_info",
           "radix_argsort", "radix_sort_pairs", "segmented_sort_pairs",
           "load_gaussians_ply", "save_gaussians_ply"]
