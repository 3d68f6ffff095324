"""The port's segment sums against the JAX package's Pallas segment-sum
kernel (interpret mode on the CPU), and the per-point slot reduction.

Streams are point-sorted keys with Poisson segment lengths, some empty
segments, a sentinel tail (key == N) and N not a multiple of 128 (the JAX
kernel's output block).

Tolerances: float64 rtol 1e-12, atol 1e-12; float32 rtol 1e-5, atol 1e-4
for values of order 1: the JAX kernel feeds float32 values to its one-hot
matmul as a bf16 high half plus a bf16-rounded low half, which keeps
about 2^-17 of each value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu.ops.raster.reduce import (
    segment_sums_by_sorted_key as jax_segment_sums)

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
    reduce, reduce_slots_by_point, segment_sums_by_sorted_key, segment_sums_plain)

import torch_port_scenes as scenes


def sorted_stream(seed, n, rows, sentinels, dtype):
  """(keys, values, offsets): ascending keys with empty segments and a
  sentinel tail; offsets are the segment starts."""
  rng = np.random.default_rng(seed)
  counts = rng.poisson(2.7, size=n)
  counts[rng.choice(n, n // 10, replace=False)] = 0
  keys = np.concatenate([np.repeat(np.arange(n), counts),
                         np.full(sentinels, n)]).astype(np.int32)
  offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
  values = rng.normal(size=(rows, keys.shape[0])).astype(dtype)
  return keys, values, offsets, counts


@pytest.mark.parametrize("dtype,n,rows,sentinels", [
    (np.float64, 300, 9, 40),     # N not a multiple of 128
    (np.float64, 256, 13, 0),     # no sentinels
    (np.float32, 1000, 12, 500),
])
def test_segment_sums_match_jax(dtype, n, rows, sentinels):
  keys, values, offsets, counts = sorted_stream(n + rows, n, rows, sentinels, dtype)
  want = np.asarray(jax_segment_sums(jnp.asarray(keys), jnp.asarray(values),
                                     jnp.asarray(offsets), n))
  got = segment_sums_by_sorted_key(torch.tensor(keys), torch.tensor(values),
                                   torch.tensor(offsets), n)
  assert got.shape == (rows, n) and got.dtype == scenes.TORCH_DTYPE[dtype]
  rtol, atol = (1e-12, 1e-12) if dtype == np.float64 else (1e-5, 1e-4)
  np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
  assert (got.numpy()[:, counts == 0] == 0).all()


def test_cpu_tensor_takes_the_plain_segment_sum():
  keys, values, offsets, _ = sorted_stream(1, 50, 3, 5, np.float32)
  before = reduce.SEGMENT_SUM.launch_count
  got = segment_sums_by_sorted_key(torch.tensor(keys), torch.tensor(values),
                                   torch.tensor(offsets), 50)
  assert reduce.SEGMENT_SUM.launch_count == before
  torch.testing.assert_close(
      got, segment_sums_plain(torch.tensor(keys), torch.tensor(values), 50),
      rtol=0, atol=0)


def test_segment_sum_kernel_input_checks():
  """The checks the CUDA wrapper runs before a launch, here on CPU tensors
  and so before any build; inputs that pass them reach the launch, which
  refuses CPU tensors."""
  keys, values, offsets, _ = sorted_stream(2, 40, 3, 0, np.float32)
  with pytest.raises(TypeError, match="float32"):
    reduce.segment_sums_cuda(torch.tensor(values).double(), torch.tensor(offsets), 40)
  with pytest.raises(TypeError, match="int32"):
    reduce.segment_sums_cuda(torch.tensor(values), torch.tensor(offsets).long(), 40)
  with pytest.raises(ValueError, match=r"\(N\+1,\)"):
    reduce.segment_sums_cuda(torch.tensor(values), torch.tensor(offsets), 41)
  with pytest.raises(ValueError, match="CUDA tensors"):
    reduce.segment_sums_cuda(torch.tensor(values), torch.tensor(offsets), 40)


def test_reduce_slots_by_point():
  """(R, K) slot rows of a real mapping -> (N, R) per-point sums, against
  a numpy sum over each point's slots; sentinel slots are never summed."""
  size = (64, 48)
  points, depth, _ = scenes.points2d(8, 300, size)
  mapping = map_to_tiles(scenes.to_torch(points), scenes.to_torch(depth), size,
                         RasterConfig(tile_size=8))
  otp = mapping.overlap_to_point.numpy()
  assert (otp == 300).any()
  slots = np.random.default_rng(9).normal(size=(5, otp.shape[0]))
  got = reduce_slots_by_point(torch.tensor(slots), mapping)
  want = np.zeros((301, 5))
  np.add.at(want, otp, slots.T)
  np.testing.assert_allclose(got.numpy(), want[:300], rtol=1e-12, atol=1e-12)
