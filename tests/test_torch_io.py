"""The port's 3DGS `.ply` IO, host primitives and Morton codes against the
JAX package's (`io`, `io.native`, `utils.morton`).

A `.ply` is the state both packages share: one written by either loads in
the other to the same arrays, exactly, Morton order included. Every
comparison here is exact (integer codes and orders, float32 arrays
copied from the file).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu import io as jax_io
from taichi_gaussian_rasterizer_tpu.io import native as jax_native
from taichi_gaussian_rasterizer_tpu.utils import morton as jax_morton

from taichi_gaussian_rasterizer_tpu_torch import io
from taichi_gaussian_rasterizer_tpu_torch.io import native
from taichi_gaussian_rasterizer_tpu_torch.utils import morton

import torch_port_scenes as scenes

FIELDS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


def jax_gaussians(seed, n, sh_degree):
  cam = scenes.camera(seed, (64, 48))
  g = scenes.gaussians3d(seed + 1, n, cam, sh_degree=sh_degree)
  return scenes.jax_scene(cam, g, np.float32)[0]


@pytest.mark.parametrize("sh_degree", [None, 0, 3])
@pytest.mark.parametrize("morton_order", [True, False])
def test_jax_written_ply_loads_in_the_port(tmp_path, sh_degree, morton_order):
  path = str(tmp_path / "jax.ply")
  jax_io.save_gaussians_ply(path, jax_gaussians(0, 300, sh_degree))
  want = jax_io.load_gaussians_ply(path, morton_order=morton_order)
  got = io.load_gaussians_ply(path, morton_order=morton_order, device="cpu")
  for name in FIELDS:
    value = getattr(got, name)
    assert value.dtype == torch.float32 and value.is_contiguous(), name
    np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(want, name)),
                                  err_msg=name)
  k = 1 if sh_degree is None else (sh_degree + 1) ** 2
  assert got.feature.shape == (300, 3, k)


@pytest.mark.parametrize("sh_degree", [None, 3])
def test_port_written_ply_loads_in_jax_and_round_trips(tmp_path, sh_degree):
  path = str(tmp_path / "port.ply")
  src = jax_gaussians(2, 200, sh_degree)
  g = scenes.torch_scene(scenes.camera(2, (64, 48)),
                         {n: np.array(getattr(src, n)) for n in FIELDS},
                         np.float32)[0]
  io.save_gaussians_ply(path, g)
  jax_path = str(tmp_path / "jax.ply")
  jax_io.save_gaussians_ply(jax_path, src)
  with open(path, "rb") as a, open(jax_path, "rb") as b:
    assert a.read() == b.read()               # the same bytes as JAX writes
  want = jax_io.load_gaussians_ply(path, morton_order=True)
  got = io.load_gaussians_ply(path, morton_order=True, device="cpu")
  back = io.load_gaussians_ply(path, morton_order=False, device="cpu")
  for name in FIELDS:
    np.testing.assert_array_equal(getattr(got, name).numpy(),
                                  np.asarray(getattr(want, name)), err_msg=name)
    original = getattr(g, name)
    if name == "feature" and original.ndim == 2:
      original = original[:, :, None]
    torch.testing.assert_close(getattr(back, name), original, rtol=0, atol=0)


def test_load_in_float64(tmp_path):
  path = str(tmp_path / "g.ply")
  jax_io.save_gaussians_ply(path, jax_gaussians(3, 50, 1))
  g32 = io.load_gaussians_ply(path, device="cpu")
  g64 = io.load_gaussians_ply(path, device="cpu", dtype=torch.float64)
  for name in FIELDS:
    assert getattr(g64, name).dtype == torch.float64
    assert torch.equal(getattr(g64, name), getattr(g32, name).double())


def test_ply_info_and_load_ply_match_jax(tmp_path):
  path = str(tmp_path / "g.ply")
  jax_io.save_gaussians_ply(path, jax_gaussians(4, 70, 2))
  assert native.ply_info(path) == jax_native.ply_info(path)
  data, names = native.load_ply(path)
  jdata, jnames = jax_native.load_ply(path)
  assert names == jnames and data.dtype == np.float32
  np.testing.assert_array_equal(data, jdata)


def test_truncated_ply_raises(tmp_path):
  path = str(tmp_path / "g.ply")
  jax_io.save_gaussians_ply(path, jax_gaussians(5, 100, None))
  with open(path, "r+b") as f:
    f.truncate(os.path.getsize(path) - 64)
  with pytest.raises(IOError):
    native.load_ply(path)
  with pytest.raises(IOError):
    io.load_gaussians_ply(path, device="cpu")


def test_non_float_property_raises(tmp_path):
  path = str(tmp_path / "bad.ply")
  with open(path, "wb") as f:
    f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
            b"property uchar red\nend_header\n\x01")
  with pytest.raises(IOError):
    native.ply_info(path)


def seeded_points(seed, n=2000, dtype=np.float32):
  rng = np.random.default_rng(seed)
  return (rng.normal(size=(n, 3)) * [3.0, 1.0, 0.5] + [1.0, -2.0, 0.3]).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_morton_matches_jax(dtype):
  xyz = seeded_points(0, dtype=dtype)
  pts, jpts = torch.from_numpy(xyz), jnp.asarray(xyz)
  codes = morton.morton_codes(pts)
  np.testing.assert_array_equal(codes.numpy(),
                                np.asarray(jax_morton.morton_codes(jpts), np.int64))
  np.testing.assert_array_equal(morton.argsort(pts).numpy(),
                                np.asarray(jax_morton.argsort(jpts)))
  order, first = morton.argsort_unique(pts, resolution=16)
  jorder, jfirst = jax_morton.argsort_unique(jpts, resolution=16)
  np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
  np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
  assert (~first).any()                       # cells with several points
  sorted_pts, extra = morton.sort(pts, torch.arange(len(xyz)))
  torch.testing.assert_close(sorted_pts, pts[morton.argsort(pts)])
  np.testing.assert_array_equal(extra.numpy(), morton.argsort(pts).numpy())


def test_host_morton3d_matches_jax():
  xyz = seeded_points(1)
  codes = native.morton3d(torch.from_numpy(xyz))
  np.testing.assert_array_equal(codes.numpy(),
                                jax_native.morton3d(xyz).astype(np.int64))


@pytest.mark.parametrize("bits", [(0, None), (4, 20), (16, 32)])
def test_radix_sort_pairs_matches_host(bits):
  rng = np.random.default_rng(2)
  keys = rng.integers(0, 2 ** 32, size=1000, dtype=np.uint64).astype(np.uint32)
  values = rng.permutation(1000).astype(np.int32)
  begin, end = bits
  kw = dict(begin_bit=begin, end_bit=end if end is not None else 32)
  want_k, want_v = jax_native.radix_sort_pairs(keys, values, **kw)
  got_k, got_v = native.radix_sort_pairs(torch.from_numpy(keys.astype(np.int64)),
                                         torch.from_numpy(values), **kw)
  np.testing.assert_array_equal(got_k.numpy(), want_k.astype(np.int64))
  np.testing.assert_array_equal(got_v.numpy(), want_v)
  np.testing.assert_array_equal(
      native.radix_argsort(torch.from_numpy(keys.astype(np.int64)), **kw).numpy(),
      jax_native.radix_argsort(keys, **kw))


def test_full_cumsum_matches_host():
  counts = np.random.default_rng(3).integers(0, 50, size=777).astype(np.int32)
  want, want_total = jax_native.full_cumsum(counts)
  got, total = native.full_cumsum(torch.from_numpy(counts))
  assert total == want_total and got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy(), want)
