"""The port's segment sums against the JAX package's Pallas segment-sum
kernel (interpret mode on the CPU), the per-point slot reduction, the
backward's slot-major layout, and the input checks of both CUDA wrappers.

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
    backward, forward, reduce, reduce_slots_by_point, segment_sums_by_sorted_key,
    segment_sums_plain)
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing

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


def test_point_sum_kernel_input_checks():
  """The checks the one-pass reduction's CUDA wrapper runs before a launch,
  here on CPU tensors and so before any build; inputs that pass them reach
  the launch, which refuses CPU tensors."""
  _, values, offsets, _ = sorted_stream(3, 40, 3, 5, np.float32)
  storage = torch.tensor(values).T.contiguous()              # (K, R)
  order = torch.arange(storage.shape[0])
  offsets = torch.tensor(offsets)
  with pytest.raises(TypeError, match="float32"):
    reduce.point_sums_cuda(storage.double(), order, offsets, 40)
  with pytest.raises(TypeError, match="int64"):
    reduce.point_sums_cuda(storage, order.int(), offsets, 40)
  with pytest.raises(TypeError, match="int32"):
    reduce.point_sums_cuda(storage, order, offsets.long(), 40)
  with pytest.raises(ValueError, match=r"\(K,\)"):
    reduce.point_sums_cuda(storage, order[1:], offsets, 40)
  with pytest.raises(ValueError, match=r"\(K, R\)"):
    reduce.point_sums_cuda(storage[:, 0], order, offsets, 40)
  with pytest.raises(ValueError, match=r"\(N\+1,\)"):
    reduce.point_sums_cuda(storage, order, offsets, 41)
  with pytest.raises(ValueError, match="contiguous"):
    reduce.point_sums_cuda(torch.tensor(values).T, order, offsets, 40)
  with pytest.raises(ValueError, match="CUDA tensors"):
    reduce.point_sums_cuda(storage, order, offsets, 40)


def _backward_rows(heuristic, vis_row, antialias):
  size = (48, 40)
  points, depth, feats = scenes.points2d(11, 150, size, n_features=4)
  pts, f = scenes.to_torch(points, np.float32), scenes.to_torch(feats, np.float32)
  config = RasterConfig(tile_size=8, antialias=antialias)
  mapping = map_to_tiles(pts, scenes.to_torch(depth, np.float32), size, config)
  image, weight = forward.rasterize_forward(pts, f, mapping, size, config)
  gen = torch.Generator().manual_seed(12)
  g_img = torch.randn(tuple(image.shape), generator=gen)
  g_w = torch.randn(tuple(weight.shape), generator=gen)
  args = (pts, f, mapping, config, image, weight, g_img, g_w)
  kw = dict(compute_point_heuristic=heuristic, vis_row=vis_row)
  return (backward.rasterize_backward(*args, **kw), mapping,
          backward.raster_backward_plain(*args, tile_ids=range(
              mapping.tile_ranges.shape[0])[::-1], **kw))


@pytest.mark.parametrize("heuristic,vis_row,antialias", [
    (False, False, False), (True, True, False), (False, True, True)])
def test_backward_rows_are_a_view_of_slot_major_storage(heuristic, vis_row,
                                                        antialias):
  """The backward's (R, K) rows are a view of (K, R) storage, each slot's R
  values contiguous, whose values equal index for index those of the plain
  backward run over the tiles in another order; the reduction takes them
  as they are, and sums them as it sums a row-major copy, bit for bit."""
  rows, mapping, other = _backward_rows(heuristic, vis_row, antialias)
  r = backward.live_grad_rows(4, heuristic, vis_row, antialias)
  assert rows.shape == other.shape == (r, mapping.overlap_to_point.shape[0])
  assert rows.stride() == (1, r) and reduce.slot_major(rows)
  assert not reduce.slot_major(rows.contiguous())
  assert torch.equal(rows, other)
  assert rows.abs().amax(dim=1).min() > 0
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    got = reduce_slots_by_point(rows, mapping)
  sort, gather = [x for x in tracing.records() if x["name"] == "tgr.reduce.sort"][-2:]
  assert sort["counts"] == {"rows": r, "chunks": 1, "kernel_rows": 0}
  assert gather["counts"] == {}
  assert got.shape == (mapping.point_sentinel, r) and got.is_contiguous()
  assert torch.equal(got, reduce_slots_by_point(rows.contiguous(), mapping))
  want = np.zeros((mapping.point_sentinel + 1, r), dtype=np.float64)
  np.add.at(want, mapping.overlap_to_point.numpy(), rows.T.double().numpy())
  np.testing.assert_allclose(got.numpy(), want[:-1], rtol=1e-5, atol=1e-6)


def test_cpu_slot_rows_take_the_plain_point_sums():
  """On CPU tensors the reduction launches no kernel: the gather into
  point order and `segment_sums_plain`."""
  keys, values, offsets, counts = sorted_stream(4, 60, 7, 9, np.float32)
  rng = np.random.default_rng(5)
  perm = rng.permutation(keys.shape[0])
  slots = torch.tensor(values[:, perm])         # slot s: point keys[perm[s]]
  point_of_slot = torch.tensor(keys[perm])
  k_sorted, order = torch.sort(point_of_slot, stable=True)
  before = (reduce.POINT_SUMS.launch_count, reduce.SEGMENT_SUM.launch_count)
  got = reduce.point_sums_by_order(k_sorted, order, slots, torch.tensor(offsets), 60)
  assert (reduce.POINT_SUMS.launch_count, reduce.SEGMENT_SUM.launch_count) == before
  assert torch.equal(got, segment_sums_plain(k_sorted, slots[:, order], 60).T)
  want = np.zeros((61, 7))
  np.add.at(want, keys, values.T.astype(np.float64))
  np.testing.assert_allclose(got.numpy(), want[:60], rtol=1e-5, atol=1e-5)
  assert (got[counts == 0] == 0).all()
