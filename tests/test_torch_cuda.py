"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without an NVIDIA GPU.

This file imports no JAX, so it also runs where JAX is not installed. The
repository's conftest.py imports JAX; on such a machine skip it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance (float32, the same inputs through both): p99.9 |diff| <= 1e-4,
and max |diff| <= 2e-2 when blending. The two sides round the pdf and
the transmittance product differently (fused multiply-adds in the kernel,
a scan in torch.cumprod), so a pixel whose alpha lies within rounding of
alpha_threshold can be gated differently: in blending mode that moves
the pixel by at most alpha_threshold times a feature, in quantile mode
it can select another point outright, so only the p99.9 bound holds
there.

Backward kernel against its plain version, slot row by slot row (float32,
the same forward outputs and cotangents through both): per row, p99.9
|diff| <= 1e-4 and max |diff| <= 1e-2 relative to the row's largest
|plain| value. The two add the per-slot sums over pixels and the running
sum C in different orders, and E - C cancels where a pixel's remaining
weight is small. Segment sums: rtol 1e-5 (sums of a few slots, added in
another order). The one-pass reduction over slot-major rows: bit for bit
the sort, the gather of the (R, K) rows into point order and the
segment-sum kernel (both add each point's values in sorted order from 0).
"""

import shutil

import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import longest_first, map_to_tiles
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import (
    backward, forward, probe_visit_chunks, rasterize_with_tiles, reduce,
    reduce_slots_by_point, tiles, truncate_mapping)
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing

import torch_port_scenes as scenes


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _scene(device, n, size, n_features, seed=30):
  points, depth, feats = scenes.points2d(seed, n, size, sigma_range=(0.8, 8.0),
                                         alpha_range=(0.3, 0.99),
                                         n_features=n_features)
  return tuple(scenes.to_torch(x, np.float32).to(device)
               for x in (points, depth, feats))


def _kernel_vs_plain(device, config, n=2000, size=(200, 120), n_features=3):
  pts, depth, f = _scene(device, n, size, n_features)
  mapping = map_to_tiles(pts, depth, size, config)
  before = forward.RASTER_FORWARD.launch_count
  image, weight = forward.rasterize_forward(pts, f, mapping, size, config)
  torch.cuda.synchronize()
  assert forward.RASTER_FORWARD.launch_count == before + 1
  tiled, tiled_w = forward.rasterize_tiles_plain(pts, f, mapping, config)
  want = tiles.tiles_to_image(
      torch.cat([tiled, tiled_w[:, None]], 1), mapping.tile_shape,
      config.tile_size, size)
  got = torch.cat([image, weight[..., None]], -1)
  assert got.shape == (size[1], size[0], n_features + 1)
  return (got - want).abs().flatten().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("blending", [True, False])
@pytest.mark.parametrize("tile_size", [8, 16, 32])
def test_kernel_matches_plain_on_card(cuda_device, antialias, blending, tile_size):
  diff = _kernel_vs_plain(cuda_device, RasterConfig(
      tile_size=tile_size, antialias=antialias, use_alpha_blending=blending))
  assert np.quantile(diff, 0.999) <= 1e-4
  if blending:
    assert diff.max() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_kernel_takes_sixteen_features(cuda_device, tile_size):
  """F = 16 at 32x32 tiles needs more than 48 KB of shared memory."""
  diff = _kernel_vs_plain(cuda_device, RasterConfig(tile_size=tile_size),
                          n_features=16)
  assert np.quantile(diff, 0.999) <= 1e-4 and diff.max() <= 2e-2


@pytest.mark.cuda
def test_mapper_on_card_matches_cpu(cuda_device):
  config = RasterConfig(tile_size=16)
  pts, depth, _ = _scene(cuda_device, 3000, (300, 200), 3)
  got = map_to_tiles(pts, depth, (300, 200), config)
  want = map_to_tiles(pts.cpu(), depth.cpu(), (300, 200), config)
  for name in ("overlap_to_point", "overlap_to_tile", "tile_ranges",
               "total_overlaps", "overflow"):
    torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name),
                               rtol=0, atol=0, msg=name)


def _backward_inputs(device, config, n=2000, size=(200, 120), n_features=3,
                     seed=30):
  """A scene, its mapping, the kernel's forward outputs and seeded
  cotangents, all float32 on the card."""
  pts, depth, f = _scene(device, n, size, n_features, seed)
  mapping = map_to_tiles(pts, depth, size, config)
  image, weight = forward.rasterize_forward(pts, f, mapping, size, config)
  rng = np.random.default_rng(seed + 1)
  g_img = torch.tensor(rng.normal(size=tuple(image.shape)), dtype=torch.float32,
                       device=device)
  g_w = torch.tensor(rng.normal(size=tuple(weight.shape)), dtype=torch.float32,
                     device=device)
  return pts, f, mapping, image, weight, g_img, g_w


def assert_rows_close(got, want):
  """Per row: p99.9 |diff| <= 1e-4 and max |diff| <= 1e-2, relative to
  the row's largest |want|."""
  scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
  rel = ((got - want).abs() / scale).cpu().numpy()
  assert np.quantile(rel, 0.999, axis=1).max() <= 1e-4, np.quantile(rel, 0.999, axis=1)
  assert rel.max(axis=1).max() <= 1e-2, rel.max(axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("vis_row", [False, True])
@pytest.mark.parametrize("tile_size", [8, 16])
def test_backward_kernel_matches_plain_on_card(cuda_device, antialias, heuristic,
                                               vis_row, tile_size):
  config = RasterConfig(tile_size=tile_size, antialias=antialias)
  args = _backward_inputs(cuda_device, config)
  before = backward.RASTER_BACKWARD.launch_count
  got = backward.rasterize_backward(*args[:3], config, *args[3:],
                                    compute_point_heuristic=heuristic,
                                    vis_row=vis_row)
  torch.cuda.synchronize()
  assert backward.RASTER_BACKWARD.launch_count == before + 1
  want = backward.raster_backward_plain(*args[:3], config, *args[3:],
                                        compute_point_heuristic=heuristic,
                                        vis_row=vis_row)
  assert got.shape == want.shape == (
      backward.live_grad_rows(3, heuristic, vis_row, antialias),
      args[2].overlap_to_point.shape[0])
  assert want.abs().amax(dim=1).min() > 0
  assert_rows_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_backward_kernel_takes_sixteen_features(cuda_device, tile_size):
  """F = 16 at 32x32 tiles needs more than 48 KB of shared memory."""
  config = RasterConfig(tile_size=tile_size)
  args = _backward_inputs(cuda_device, config, n_features=16)
  kw = dict(compute_point_heuristic=True, vis_row=True)
  got = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  want = backward.raster_backward_plain(*args[:3], config, *args[3:], **kw)
  assert_rows_close(got, want)


@pytest.mark.cuda
def test_backward_is_deterministic(cuda_device):
  """No atomics: two backward passes and two reductions are bitwise equal."""
  config = RasterConfig(tile_size=16)
  args = _backward_inputs(cuda_device, config, n=5000, size=(320, 240))
  kw = dict(compute_point_heuristic=True, vis_row=True)
  a = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  b = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  assert torch.equal(a, b)
  assert torch.equal(reduce_slots_by_point(a, args[2]),
                     reduce_slots_by_point(b, args[2]))


@pytest.mark.cuda
def test_segment_sum_kernel_matches_plain(cuda_device):
  """Empty segments, sentinel keys and N not a multiple of 128."""
  rng = np.random.default_rng(7)
  n, k = 1000, 6000
  counts = rng.poisson(3.0, size=n)
  counts[rng.choice(n, 100, replace=False)] = 0
  keys = np.concatenate([np.repeat(np.arange(n), counts),
                         np.full(k - counts.sum(), n)]).astype(np.int32)
  offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
  values = rng.normal(size=(5, k)).astype(np.float32)
  keys_t, off_t, val_t = (torch.tensor(x, device=cuda_device)
                          for x in (keys, offsets, values))
  before = reduce.SEGMENT_SUM.launch_count
  got = reduce.segment_sums_by_sorted_key(keys_t, val_t, off_t, n)
  torch.cuda.synchronize()
  assert reduce.SEGMENT_SUM.launch_count == before + 1
  want = reduce.segment_sums_plain(keys_t, val_t, n)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
  assert (got[:, counts == 0] == 0).all()


def _gathered_segment_sums(slots, mapping):
  """The reduction as it was composed before the one-pass kernel: the
  stable sort, the gather of the (R, K) rows into point order, the
  segment-sum kernel. (N, R)."""
  _, order = torch.sort(mapping.overlap_to_point, stable=True)
  return reduce.segment_sums_cuda(slots.index_select(1, order),
                                  mapping.point_offsets,
                                  mapping.point_sentinel).T


def _mapping_with_empty_segments(device):
  """A mapping with sentinel slots and points that own no slot (every
  seventh point's alpha 0)."""
  pts, depth, _ = _scene(device, 3000, (300, 200), 3)
  pts[::7, 6] = 0.0
  mapping = map_to_tiles(pts, depth, (300, 200), RasterConfig(tile_size=16))
  segments = mapping.point_offsets[1:] - mapping.point_offsets[:-1]
  assert (mapping.overlap_to_point == 3000).any() and (segments == 0).any()
  return pts, mapping


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 9, 12, 137])
def test_point_sums_equal_the_gathered_segment_sums(cuda_device, rows):
  """Seeded slot-major rows of a mapping with sentinel slots and empty
  segments: the one-pass kernel's (N, R) sums equal the gathered segment
  sums bit for bit, empty segments give 0, one launch, two runs equal; a
  row-major (R, K) input is repacked and gives the same sums."""
  _, mapping = _mapping_with_empty_segments(cuda_device)
  k, n = mapping.overlap_to_point.shape[0], mapping.point_sentinel
  gen = torch.Generator(device=cuda_device).manual_seed(rows)
  slots = torch.randn((k, rows), generator=gen, device=cuda_device).T
  assert reduce.slot_major(slots)
  before = reduce.POINT_SUMS.launch_count
  got = reduce_slots_by_point(slots, mapping)
  torch.cuda.synchronize()
  assert reduce.POINT_SUMS.launch_count == before + 1
  assert got.shape == (n, rows) and got.is_contiguous()
  assert torch.equal(got, _gathered_segment_sums(slots, mapping))
  segments = mapping.point_offsets[1:] - mapping.point_offsets[:-1]
  assert (got[segments == 0] == 0).all() and (got[segments > 0] != 0).any()
  assert torch.equal(got, reduce_slots_by_point(slots, mapping))
  assert torch.equal(got, reduce_slots_by_point(slots.contiguous(), mapping))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [9, 137])
def test_point_sums_on_a_truncated_mapping(cuda_device, rows):
  """On a mapping cut by `truncate_mapping` (each tile's bin kept to its
  saturation front), the one-pass sums equal the gathered segment sums
  bit for bit."""
  points, depth, feats = scenes.points2d(70, 3000, (200, 120),
                                         sigma_range=(3.0, 10.0),
                                         alpha_range=(0.75, 0.99))
  pts, d = (scenes.to_torch(x, np.float32).to(cuda_device) for x in (points, depth))
  config = RasterConfig(tile_size=16)
  mapping = map_to_tiles(pts, d, (200, 120), config)
  visit, cap = probe_visit_chunks(pts, mapping, config, margin_chunks=0)
  cut, _, _ = truncate_mapping(mapping, visit, cap, config.points_per_chunk)
  k = cut.overlap_to_point.shape[0]
  assert k < mapping.overlap_to_point.shape[0]
  gen = torch.Generator(device=cuda_device).manual_seed(rows)
  slots = torch.randn((k, rows), generator=gen, device=cuda_device).T
  got = reduce_slots_by_point(slots, cut)
  assert torch.equal(got, _gathered_segment_sums(slots, cut))


@pytest.mark.cuda
@pytest.mark.parametrize("n_features", [3, 34])
def test_backward_rows_reach_the_reduction_without_a_repack(cuda_device,
                                                            n_features):
  """The backward kernel's rows (the register and the wide instance) are
  slot-major: the training step's reduction counts every row as the
  kernel's (`kernel_rows` == `rows` of `tgr.reduce.sort`), and its sums
  equal the gathered segment sums of the same rows bit for bit."""
  config = RasterConfig(tile_size=16)
  args = _backward_inputs(cuda_device, config, n_features=n_features)
  slots = backward.rasterize_backward(*args[:3], config, *args[3:])
  assert reduce.slot_major(slots)
  assert torch.equal(reduce_slots_by_point(slots, args[2]),
                     _gathered_segment_sums(slots, args[2]))
  pts, f = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
  size = (args[3].shape[1], args[3].shape[0])
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    out = rasterize_with_tiles(pts, f, args[2], size, config)
    torch.autograd.grad((out.image * args[5]).sum(), [pts, f])
    torch.cuda.synchronize()
  sort = [r for r in tracing.records()
          if r["name"] == "tgr.reduce.sort" and r["counts"]][-1]
  assert sort["counts"] == {"rows": 6 + n_features, "chunks": 1,
                            "kernel_rows": 6 + n_features}


@pytest.mark.cuda
def test_training_gradients_match_plain_autograd_on_card(cuda_device):
  """The autograd Function (kernels 1-3 and the chain) against autograd
  through the plain forward on the card: relative L2 <= 1e-3."""
  config = RasterConfig(tile_size=16)
  size = (200, 120)
  pts, depth, f = _scene(cuda_device, 2000, size, 3)
  mapping = map_to_tiles(pts, depth, size, config)
  rng = np.random.default_rng(5)
  g_img = torch.tensor(rng.normal(size=(size[1], size[0], 3)),
                       dtype=torch.float32, device=cuda_device)
  g_w = torch.tensor(rng.normal(size=(size[1], size[0])), dtype=torch.float32,
                     device=cuda_device)

  def grads(render):
    p, ff = pts.clone().requires_grad_(), f.clone().requires_grad_()
    image, weight = render(p, ff)
    return torch.autograd.grad((image * g_img).sum() + (weight * g_w).sum(),
                               [p, ff])

  def kernels(p, ff):
    out = rasterize_with_tiles(p, ff, mapping, size, config)
    return out.image, out.image_weight

  def plain(p, ff):
    image, weight = forward.rasterize_tiles_plain(p, ff, mapping, config)
    return (tiles.tiles_to_image(image, mapping.tile_shape, 16, size),
            tiles.tiles_to_image(weight[:, None], mapping.tile_shape, 16, size)[..., 0])

  counts = [k.launch_count for k in (forward.RASTER_FORWARD,
                                     backward.RASTER_BACKWARD,
                                     reduce.POINT_SUMS)]
  got = grads(kernels)
  assert [k.launch_count for k in (forward.RASTER_FORWARD,
                                   backward.RASTER_BACKWARD,
                                   reduce.POINT_SUMS)] == [c + 1 for c in counts]
  for a, b in zip(got, grads(plain)):
    assert float((a - b).norm() / b.norm()) <= 1e-3


@pytest.mark.cuda
def test_kernel_raises_on_float64_and_backward(cuda_device):
  """float64 on the card raises in the forward and the backward kernel's
  wrapper; in float32 the backward runs through the kernels."""
  pts, depth, f = (x.double() for x in _scene(cuda_device, 50, (32, 24), 3, 31))
  config = RasterConfig(tile_size=8)
  mapping = map_to_tiles(pts, depth, (32, 24), config)
  with pytest.raises(TypeError, match="float32"):
    forward.rasterize_forward(pts, f, mapping, (32, 24), config)
  ones = torch.ones(24, 32, 3, dtype=torch.float64, device=cuda_device)
  with pytest.raises(TypeError, match="float32"):
    backward.rasterize_backward(pts, f, mapping, config, ones, ones[..., 0],
                                ones, ones[..., 0])
  pts32 = pts.float().requires_grad_()
  out = rasterize_with_tiles(pts32, f.float(), mapping, (32, 24), config)
  before = backward.RASTER_BACKWARD.launch_count
  out.image.sum().backward()
  assert backward.RASTER_BACKWARD.launch_count == before + 1
  assert torch.isfinite(pts32.grad).all() and pts32.grad.abs().sum() > 0


def _forward_visibility(device, config, n=2000, size=(200, 120)):
  pts, depth, f = _scene(device, n, size, 3)
  mapping = map_to_tiles(pts, depth, size, config)
  before = forward.RASTER_FORWARD.launch_count
  got = forward.rasterize_forward(pts, f, mapping, size, config,
                                  compute_visibility=True)
  torch.cuda.synchronize()
  assert forward.RASTER_FORWARD.launch_count == before + 1
  _, _, want = forward.rasterize_tiles_plain(pts, f, mapping, config,
                                             visibility_image_size=size)
  return pts, f, mapping, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("blending", [True, False])
@pytest.mark.parametrize("tile_size", [8, 16])
def test_forward_visibility_kernel_matches_plain(cuda_device, antialias, blending,
                                                 tile_size):
  """Per-slot visibility against the plain version: p99.9 |diff| <= 1e-4
  of the largest slot value, and max <= 1e-2 of it when blending (in
  quantile mode a borderline pixel can select another point). The image
  and weight are the visibility-free launch's to atol 1e-6; two runs are
  bitwise identical; slots past the real overlaps hold 0."""
  config = RasterConfig(tile_size=tile_size, antialias=antialias,
                        use_alpha_blending=blending)
  size = (200, 120)
  pts, f, mapping, (image, weight, vis), want = _forward_visibility(cuda_device, config)
  scale = float(want.abs().max())
  assert scale > 0
  rel = ((vis - want).abs() / scale).cpu().numpy()
  assert np.quantile(rel, 0.999) <= 1e-4
  if blending:
    assert rel.max() <= 1e-2
  image0, weight0 = forward.rasterize_forward(pts, f, mapping, size, config)
  torch.testing.assert_close(image, image0, rtol=0, atol=1e-6)
  torch.testing.assert_close(weight, weight0, rtol=0, atol=1e-6)
  again = forward.rasterize_forward(pts, f, mapping, size, config,
                                    compute_visibility=True)[2]
  assert torch.equal(vis, again)
  assert (vis[int(mapping.total_overlaps):] == 0).all()


@pytest.mark.cuda
def test_forward_visibility_equals_the_sink_on_card(cuda_device):
  """Blending: the forward's per-point visibility (kernels 1 and 3) equals
  the visibility sink's gradient (kernels 2 and 3) bit for bit -- both sum
  the same weights in the same order -- and adds up to the weight image
  (rtol 1e-5)."""
  config = RasterConfig(tile_size=16, compute_visibility=True)
  size = (200, 120)
  pts, depth, f = _scene(cuda_device, 3000, size, 3)
  mapping = map_to_tiles(pts, depth, size, config)
  counts = (forward.RASTER_FORWARD.launch_count, reduce.POINT_SUMS.launch_count)
  out = rasterize_with_tiles(pts, f, mapping, size, config)
  assert (forward.RASTER_FORWARD.launch_count,
          reduce.POINT_SUMS.launch_count) == (counts[0] + 1, counts[1] + 1)
  vs = torch.zeros(3000, device=cuda_device, requires_grad=True)
  p = pts.clone().requires_grad_()
  rasterize_with_tiles(p, f, mapping, size, config,
                       visibility_sink=vs).image.sum().backward()
  assert torch.equal(out.visibility, vs.grad)
  torch.testing.assert_close(out.visibility.sum(), out.image_weight.sum(),
                             rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_forward_visibility_at_tile_4_matches_plain(cuda_device):
  """Tile 4 (16 pixels, half a warp) with visibility launches, in a block
  padded to a whole warp, and matches plain."""
  size = (32, 24)
  pts, depth, f = _scene(cuda_device, 100, size, 3)
  config = RasterConfig(tile_size=4)
  mapping = map_to_tiles(pts, depth, size, config)
  before = forward.RASTER_FORWARD.launch_count
  image, weight, vis = forward.rasterize_forward(pts, f, mapping, size, config,
                                                 compute_visibility=True)
  torch.cuda.synchronize()
  assert forward.RASTER_FORWARD.launch_count == before + 1
  want_img, want_w, want_vis = forward.rasterize_tiles_plain(
      pts, f, mapping, config, visibility_image_size=size)
  want = tiles.tiles_to_image(torch.cat([want_img, want_w[:, None]], 1),
                              mapping.tile_shape, 4, size)
  diff = (torch.cat([image, weight[..., None]], -1) - want).abs()
  assert float(diff.max()) <= 2e-2
  scale = float(want_vis.abs().max())
  assert scale > 0 and float((vis - want_vis).abs().max()) <= 1e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True])
def test_depth16_mapper_on_card_matches_cpu(cuda_device, deterministic):
  config = RasterConfig(tile_size=16, deterministic=deterministic)
  pts, depth, _ = _scene(cuda_device, 3000, (300, 200), 3)
  depth = torch.round(depth * 50) / 50       # many quantized ties
  got = map_to_tiles(pts, depth, (300, 200), config, use_depth16=True)
  want = map_to_tiles(pts.cpu(), depth.cpu(), (300, 200), config, use_depth16=True)
  for name in ("overlap_to_point", "overlap_to_tile", "tile_ranges",
               "total_overlaps", "overflow", "point_offsets"):
    torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name),
                               rtol=0, atol=0, msg=name)


@pytest.mark.cuda
def test_train_epoch_on_card_matches_cpu(cuda_device):
  """Three trainer steps on the card (each launching each kernel once)
  against the same steps on the CPU, float32: the loss to rtol 1e-4 and
  each parameter to relative L2 1e-2 (LaProp divides each gradient by its
  running RMS, so a near-zero gradient that rounds differently moves its
  parameter by up to a learning-rate step)."""
  from taichi_gaussian_rasterizer_tpu_torch.examples import fit_image_gaussians as fit
  from taichi_gaussian_rasterizer_tpu_torch.utils.random_data import random_2d_gaussians

  size = (128, 96)
  config = RasterConfig(tile_size=16, compute_point_heuristic=True)
  g = random_2d_gaussians(torch.Generator().manual_seed(0), 500, size,
                          alpha_range=(0.7, 0.9))
  ref = fit.synthetic_target(size, device="cpu")
  kernels = (forward.RASTER_FORWARD, backward.RASTER_BACKWARD, reduce.POINT_SUMS)
  before = [k.launch_count for k in kernels]
  card = fit.train_epoch(fit.make_parameter_class(g.to(cuda_device)),
                         ref.to(cuda_device), size, config, epoch_size=3)
  torch.cuda.synchronize()
  assert [k.launch_count - b for k, b in zip(kernels, before)] == [3, 3, 3]
  cpu = fit.train_epoch(fit.make_parameter_class(g), ref, size, config,
                        epoch_size=3)
  torch.testing.assert_close(card[4].cpu(), cpu[4], rtol=1e-4, atol=0)
  for k in fit.TENSOR_KEYS:
    got, want = card[0].tensors[k].cpu(), cpu[0].tensors[k]
    assert float((got - want).norm()) <= 1e-2 * float(want.norm()), k
  assert (card[3] >= 0).all() and torch.isfinite(card[2]).all()


# ---- the block layout, the batches and the tile queue ----------------------

BATCHES = (128, 256)   # slots a batch: kBatch of the backward and the forward


def _constructed_bins(device, lengths, saturating=(), tile_size=16,
                      n_features=3, seed=40):
  """One row of tiles whose bins hold `lengths` slots, each slot a point
  near its tile; the tiles in `saturating` get wide opaque points, so
  that their pixels saturate inside a batch. A few sentinel slots trail
  the bins, as the mapper's do."""
  from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import TileMapping
  rng = np.random.default_rng(seed)
  ts, n_tiles = tile_size, len(lengths)
  rows, feats = [], []
  for i, m in enumerate(lengths):
    opaque = i in saturating
    mean = rng.uniform(size=(m, 2)) * (ts + 8) - 4 + [i * ts, 0]
    sigma = np.sort(rng.uniform(*((3.0, 10.0) if opaque else (0.8, 6.0)),
                                size=(m, 2)), axis=1)[:, ::-1]
    theta = rng.uniform(0, np.pi, size=m)
    alpha = rng.uniform(*((0.6, 0.99) if opaque else (0.05, 0.6)), size=m)
    rows.append(np.concatenate([mean, np.cos(theta)[:, None],
                                np.sin(theta)[:, None], sigma, alpha[:, None]], 1))
    feats.append(rng.uniform(size=(m, n_features)))
  n = int(sum(lengths))
  tail = 5
  ends = np.cumsum(lengths)
  as_i32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.int32, device=device)
  mapping = TileMapping(
      overlap_to_point=as_i32(np.concatenate([np.arange(n), np.full(tail, n)])),
      overlap_to_tile=as_i32(np.concatenate(
          [np.repeat(np.arange(n_tiles), lengths), np.full(tail, n_tiles)])),
      tile_ranges=as_i32(np.stack([ends - lengths, ends], 1)),
      tile_shape=(1, n_tiles),
      total_overlaps=torch.tensor(n, device=device),
      overflow=torch.tensor(False, device=device),
      point_sentinel=n,
      point_offsets=as_i32(np.arange(n + 1)))
  pts = torch.tensor(np.concatenate(rows), dtype=torch.float32, device=device)
  f = torch.tensor(np.concatenate(feats), dtype=torch.float32, device=device)
  return pts, f, mapping, (ts * n_tiles, ts)


def _both_kernels_against_plain(device, pts, f, mapping, size, config):
  """Forward (image, weight, visibility) and backward (heuristic and
  visibility rows) against plain; the forward's visibility equal to the
  backward's visibility row bit for bit. Returns the backward rows."""
  image, weight, vis = forward.rasterize_forward(pts, f, mapping, size, config,
                                                 compute_visibility=True)
  want_img, want_w, want_vis = forward.rasterize_tiles_plain(
      pts, f, mapping, config, visibility_image_size=size)
  want = tiles.tiles_to_image(torch.cat([want_img, want_w[:, None]], 1),
                              mapping.tile_shape, config.tile_size, size)
  diff = (torch.cat([image, weight[..., None]], -1) - want).abs()
  assert float(diff.max()) <= 2e-2
  assert float(torch.quantile(diff.flatten(), 0.999)) <= 1e-4
  scale = float(want_vis.abs().max())
  assert scale > 0
  assert float((vis - want_vis).abs().max()) <= 1e-2 * scale
  rng = np.random.default_rng(3)
  g_img = torch.tensor(rng.normal(size=tuple(image.shape)), dtype=torch.float32,
                       device=device)
  g_w = torch.tensor(rng.normal(size=tuple(weight.shape)), dtype=torch.float32,
                     device=device)
  args = (pts, f, mapping, config, image, weight, g_img, g_w)
  rows = backward.rasterize_backward(*args, compute_point_heuristic=True,
                                     vis_row=True)
  assert_rows_close(rows, backward.raster_backward_plain(
      *args, compute_point_heuristic=True, vis_row=True))
  vis_row = (7 if config.antialias else 6) + 2
  assert torch.equal(vis, rows[vis_row])
  return rows


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
def test_kernels_on_bins_of_every_batch_shape(cuda_device, antialias):
  """Bins of 0 slots, 1 slot, exactly one batch of either kernel, several
  batches with a short last one, and two tiles that saturate inside a
  batch; the slots after a saturated tile's stop and the sentinel tail
  hold 0."""
  lengths = (0, 1, *BATCHES, 300, 700, 300)
  pts, f, mapping, size = _constructed_bins(cuda_device, lengths,
                                            saturating=(5, 6))
  config = RasterConfig(tile_size=16, antialias=antialias)
  rows = _both_kernels_against_plain(cuda_device, pts, f, mapping, size, config)
  assert (rows[:, int(mapping.total_overlaps):] == 0).all()
  end = int(mapping.tile_ranges[5, 1])
  assert (rows[:, end - 200:end] == 0).all()   # the saturated tile's last slots


@pytest.mark.cuda
@pytest.mark.parametrize("n_features", [1, 3, 16])
@pytest.mark.parametrize("tile_size", [8, 16, 32])
def test_kernels_at_every_tile_size_and_width(cuda_device, tile_size, n_features):
  """Both kernels against plain for tile sizes 8, 16, 32 (two or four
  pixels a thread) and F = 1, 3, 16 (the F <= 4 and F <= 16 instances);
  the forward's visibility equals the backward's visibility row bit for
  bit at every tile size."""
  config = RasterConfig(tile_size=tile_size)
  size = (200, 120)
  pts, depth, f = _scene(cuda_device, 2000, size, n_features)
  mapping = map_to_tiles(pts, depth, size, config)
  _both_kernels_against_plain(cuda_device, pts, f, mapping, size, config)


@pytest.mark.cuda
def test_two_runs_identical_under_the_tile_queue(cuda_device):
  """More tiles than the persistent grid holds at once, so blocks take
  tiles from the queue in an order that varies between runs: the image,
  the visibility and the backward rows are bitwise identical all the
  same."""
  config = RasterConfig(tile_size=16)
  args = _backward_inputs(cuda_device, config, n=20_000, size=(1280, 960))
  pts, f, mapping = args[:3]
  a = forward.rasterize_forward(pts, f, mapping, (1280, 960), config,
                                compute_visibility=True)
  b = forward.rasterize_forward(pts, f, mapping, (1280, 960), config,
                                compute_visibility=True)
  assert all(torch.equal(x, y) for x, y in zip(a, b))
  kw = dict(compute_point_heuristic=True, vis_row=True)
  r1 = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  r2 = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  assert torch.equal(r1, r2)


@pytest.mark.cuda
def test_tile_order_on_card_matches_cpu(cuda_device):
  config = RasterConfig(tile_size=16)
  pts, depth, _ = _scene(cuda_device, 3000, (300, 200), 3)
  mapping = map_to_tiles(pts, depth, (300, 200), config)
  got = mapping.tile_order
  assert got.dtype == torch.int32 and got.is_cuda
  assert torch.equal(got.cpu(), longest_first(mapping.tile_ranges.cpu()))


# the test in raster_common.cuh's outside_box, and its replacement in a
# build whose box skips nothing
_BOX_TEST = "return fabsf(cx - m.x) > e.x || ry > e.y;"
_boxless = {}


def _boxless_kernels(tmp_dir):
  """The forward and backward kernels built from a copy of csrc/ whose
  outside_box never skips a slot (built once)."""
  if not _boxless:
    from taichi_gaussian_rasterizer_tpu_torch.utils import cuda_build
    csrc = tmp_dir / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    header = csrc / "raster_common.cuh"
    text = header.read_text()
    assert text.count(_BOX_TEST) == 1
    header.write_text(text.replace(_BOX_TEST, "return false;"))
    kernels = {"RASTER_FORWARD": forward.RASTER_FORWARD,
               "RASTER_BACKWARD": backward.RASTER_BACKWARD}
    built = {name: cuda_build.CudaKernel(k.source, k.symbol, k.signature)
             for name, k in kernels.items()}
    saved = cuda_build.CSRC_DIR, cuda_build.BUILD_DIR
    cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = csrc, tmp_dir / "build"
    try:
      cuda_build.load_all(list(built.values()))
    finally:
      cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = saved
    _boxless.update(built)
  return _boxless


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("aspect", [30.0, 3000.0])
def test_threshold_box_keeps_every_pixel_above_threshold(
    cuda_device, tmp_path_factory, monkeypatch, aspect, antialias):
  """The kernels skip a (pixel, slot) pair outside the slot's threshold
  box. Thin splats (sigma ratios up to 30 and 3000, where the conic box
  grows with the conditioning or is unbounded) with alphas just above the
  threshold put many pixels near the box edge: the image, weight,
  visibility (blending and quantile) and backward rows match the plain
  version, and are bitwise equal to the same kernels built with a box
  that skips nothing."""
  rng = np.random.default_rng(50)
  n, size = 1500, (160, 96)
  mean = rng.uniform(size=(n, 2)) * [size[0], size[1]]
  theta = rng.uniform(0, np.pi, size=n)
  long_side = rng.uniform(2.0, 12.0, size=n)
  sigma = np.stack([long_side, long_side / rng.uniform(1.0, aspect, size=n)], 1)
  alpha = rng.uniform(1.0 / 255.0, 3.0 / 255.0, size=n)
  alpha[: n // 2] = rng.uniform(0.2, 0.9, size=n // 2)
  pts = torch.tensor(np.concatenate(
      [mean, np.cos(theta)[:, None], np.sin(theta)[:, None], sigma,
       alpha[:, None]], 1), dtype=torch.float32, device=cuda_device)
  depth = torch.tensor(rng.permutation(n) / n + 0.1, dtype=torch.float32,
                       device=cuda_device)
  f = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32,
                   device=cuda_device)
  config = RasterConfig(tile_size=16, antialias=antialias)
  mapping = map_to_tiles(pts, depth, size, config)
  _both_kernels_against_plain(cuda_device, pts, f, mapping, size, config)

  def outputs():
    out = []
    for cfg in (config, config.replace(use_alpha_blending=False)):
      out += forward.rasterize_forward(pts, f, mapping, size, cfg)
      out += forward.rasterize_forward(pts, f, mapping, size, cfg,
                                       compute_visibility=True)
    image, weight = out[:2]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    g_img = torch.randn(tuple(image.shape), generator=g, device=cuda_device)
    g_w = torch.randn(tuple(weight.shape), generator=g, device=cuda_device)
    out.append(backward.rasterize_backward(
        pts, f, mapping, config, image, weight, g_img, g_w,
        compute_point_heuristic=True, vis_row=True))
    return out

  boxed = outputs()
  for name, kernel in _boxless_kernels(tmp_path_factory.mktemp("boxless")).items():
    monkeypatch.setattr(forward if name == "RASTER_FORWARD" else backward,
                        name, kernel)
  unboxed = outputs()
  assert all(torch.equal(a, b) for a, b in zip(boxed, unboxed))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [8, 16, 32])
def test_tile_front_and_truncation_on_card(cuda_device, tile_size):
  """Kernel 1's per-tile saturation front against the plain version's,
  in every instance with blending (conic and antialias, with and without
  visibility): equal but on a few tiles where a gate flips between the
  two roundings (at most 1% of the non-empty tiles), and bitwise the same
  whatever the instance and on a second run. Then saturation-front
  truncation at the kernel's fronts: no crop flagged, and the image, the
  weight, the forward visibility and the gradients wrt points, features
  and both sinks bitwise equal to the untruncated render's."""
  points, depth, feats = scenes.points2d(70, 3000, (200, 120), sigma_range=(3.0, 10.0),
                                         alpha_range=(0.75, 0.99))
  pts, d, f = (scenes.to_torch(x, np.float32).to(cuda_device)
               for x in (points, depth, feats))
  size = (200, 120)
  for antialias in (False, True):
    config = RasterConfig(tile_size=tile_size, antialias=antialias)
    mapping = map_to_tiles(pts, d, size, config)
    bins = mapping.tile_ranges[:, 1] - mapping.tile_ranges[:, 0]
    fronts = [forward.rasterize_forward(pts, f, mapping, size, config,
                                        compute_visibility=vis,
                                        tile_front=True)[-1]
              for vis in (False, True, False)]
    assert fronts[0].dtype == torch.int32 and fronts[0].shape == bins.shape
    assert torch.equal(fronts[0], fronts[1]) and torch.equal(fronts[0], fronts[2])
    plain = forward.rasterize_tiles_plain(pts, f, mapping, config,
                                          front_image_size=size)[-1]
    differ = int((fronts[0] != plain).sum())
    assert differ <= max(1, int(0.01 * int((bins > 0).sum()))), differ
    assert (fronts[0] > 0).sum() > (bins > 0).sum() // 2     # it saturates
    assert (fronts[0][bins == 0] == 0).all()

    cfg = config.replace(compute_point_heuristic=True, compute_visibility=True)
    visit, cap = probe_visit_chunks(pts, mapping, cfg, margin_chunks=0)
    assert cap < mapping.overlap_to_point.shape[0]

    def run(**visit_args):
      p, ff = pts.clone().requires_grad_(), f.clone().requires_grad_()
      hs = torch.zeros(p.shape[0], 2, device=cuda_device, requires_grad=True)
      vs = torch.zeros(p.shape[0], device=cuda_device, requires_grad=True)
      out = rasterize_with_tiles(p, ff, mapping, size, cfg, **visit_args)
      sink = rasterize_with_tiles(p, ff, mapping, size, cfg, heuristic_sink=hs,
                                  visibility_sink=vs, **visit_args)
      loss = (sink.image ** 2).sum() + sink.image_weight.sum()
      return out, sink, torch.autograd.grad(loss, [p, ff, hs, vs])

    full, full_sink, g_full = run()
    tr, tr_sink, g_tr = run(visit_chunks=visit, visit_capacity=cap)
    assert not bool(tr.bin_overflow) and not bool(tr_sink.bin_overflow)
    for a, b in [(tr.image, full.image), (tr.image_weight, full.image_weight),
                 (tr.visibility, full.visibility), (tr_sink.image, full_sink.image),
                 *zip(g_tr, g_full)]:
      assert torch.equal(a, b)


# ---- any feature width: the channel-group instances (F > 16) ---------------

WIDE_FEATURES = (17, 32, 34, 64, 128, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("n_features", WIDE_FEATURES)
@pytest.mark.parametrize("tile_size", [8, 16, 32])
def test_wide_kernels_match_plain(cuda_device, tile_size, n_features):
  """Past 16 channels: the forward in all four modes and the backward,
  conic and antialias, with and without the heuristic and visibility
  rows, against plain at the tolerances above; one launch each."""
  for antialias in (False, True):
    for blending in (True, False):
      config = RasterConfig(tile_size=tile_size, antialias=antialias,
                            use_alpha_blending=blending)
      diff = _kernel_vs_plain(cuda_device, config, n_features=n_features)
      assert np.quantile(diff, 0.999) <= 1e-4, (antialias, blending)
      if blending:
        assert diff.max() <= 2e-2, (antialias, blending)
    config = RasterConfig(tile_size=tile_size, antialias=antialias)
    args = _backward_inputs(cuda_device, config, n_features=n_features)
    for extra in (False, True):
      kw = dict(compute_point_heuristic=extra, vis_row=extra)
      before = backward.RASTER_BACKWARD.launch_count
      got = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
      torch.cuda.synchronize()
      assert backward.RASTER_BACKWARD.launch_count == before + 1
      want = backward.raster_backward_plain(*args[:3], config, *args[3:], **kw)
      assert got.shape == want.shape == (
          backward.live_grad_rows(n_features, extra, extra, antialias),
          args[2].overlap_to_point.shape[0])
      assert want.abs().amax(dim=1).min() > 0
      assert_rows_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("n_features", [34, 129])
def test_wide_visibility_equals_the_backward_row(cuda_device, n_features,
                                                 antialias):
  """The wide forward's visibility equals the wide backward's visibility
  row bit for bit, on bins of every batch shape with saturating tiles."""
  lengths = (0, 1, *BATCHES, 300, 700, 300)
  pts, f, mapping, size = _constructed_bins(cuda_device, lengths,
                                            saturating=(5, 6),
                                            n_features=n_features)
  config = RasterConfig(tile_size=16, antialias=antialias)
  rows = _both_kernels_against_plain(cuda_device, pts, f, mapping, size, config)
  assert (rows[:, int(mapping.total_overlaps):] == 0).all()


@pytest.mark.cuda
def test_wide_two_runs_identical(cuda_device):
  """More (tile, channel chunk) items than the persistent grid holds at once: the
  wide image, weight, visibility, front and backward rows are bitwise
  identical on a second run."""
  config = RasterConfig(tile_size=16)
  size = (1280, 960)
  args = _backward_inputs(cuda_device, config, n=20_000, size=size,
                          n_features=34)
  pts, f, mapping = args[:3]
  a, b = (forward.rasterize_forward(pts, f, mapping, size, config,
                                    compute_visibility=True, tile_front=True)
          for _ in range(2))
  assert all(torch.equal(x, y) for x, y in zip(a, b))
  kw = dict(compute_point_heuristic=True, vis_row=True)
  r1, r2 = (backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
            for _ in range(2))
  assert torch.equal(r1, r2)


@pytest.mark.cuda
def test_kernels_take_1024_features(cuda_device):
  """F = 1024 launches (22 forward channel chunks, 16 feature slices of
  the backward's D) with bounded shared memory and matches plain."""
  config = RasterConfig(tile_size=16)
  diff = _kernel_vs_plain(cuda_device, config, n=500, size=(64, 48),
                          n_features=1024)
  assert np.quantile(diff, 0.999) <= 1e-4 and diff.max() <= 2e-2
  args = _backward_inputs(cuda_device, config, n=500, size=(64, 48),
                          n_features=1024)
  kw = dict(compute_point_heuristic=True, vis_row=True)
  got = backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
  want = backward.raster_backward_plain(*args[:3], config, *args[3:], **kw)
  assert_rows_close(got, want)


# ---- every tile size: blocks padded to whole warps, tiles in pixel chunks --

ODD_TILES = (1, 4, 12, 24, 40, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("n_features", [3, 16, 17, 34, 129])
@pytest.mark.parametrize("tile_size", ODD_TILES)
def test_kernels_at_any_tile_size(cuda_device, tile_size, n_features):
  """Tiles that are not whole warps (1, 4, 12, 24) or larger than a block
  (40, 64: pixel chunks), in the register (F = 3, 16) and wide (17, 34,
  129) instances: the forward in all four modes, with visibility and with
  tile_front, and the backward with and without the heuristic and
  visibility rows, against plain at the tolerances above; the forward's
  visibility equals the backward's visibility row bit for bit; two runs
  are bitwise identical; one launch each."""
  size = (200, 120)
  for antialias in (False, True):
    for blending in (True, False):
      config = RasterConfig(tile_size=tile_size, antialias=antialias,
                            use_alpha_blending=blending)
      diff = _kernel_vs_plain(cuda_device, config, size=size,
                              n_features=n_features)
      assert np.quantile(diff, 0.999) <= 1e-4, (antialias, blending)
      if blending:
        assert diff.max() <= 2e-2, (antialias, blending)
  for antialias in (False, True):
    config = RasterConfig(tile_size=tile_size, antialias=antialias)
    args = _backward_inputs(cuda_device, config, size=size, n_features=n_features)
    pts, f, mapping = args[:3]
    before = (forward.RASTER_FORWARD.launch_count,
              backward.RASTER_BACKWARD.launch_count)
    _both_kernels_against_plain(cuda_device, pts, f, mapping, size, config)
    rows = backward.rasterize_backward(*args[:3], config, *args[3:])
    torch.cuda.synchronize()
    assert (forward.RASTER_FORWARD.launch_count,
            backward.RASTER_BACKWARD.launch_count) == (before[0] + 1, before[1] + 2)
    want = backward.raster_backward_plain(*args[:3], config, *args[3:])
    assert rows.shape == want.shape == (
        backward.live_grad_rows(n_features, False, False, antialias),
        mapping.overlap_to_point.shape[0])
    assert want.abs().amax(dim=1).min() > 0
    assert_rows_close(rows, want)
    kw = dict(compute_point_heuristic=True, vis_row=True)
    assert torch.equal(*(backward.rasterize_backward(*args[:3], config, *args[3:], **kw)
                         for _ in range(2)))
    runs = [forward.rasterize_forward(pts, f, mapping, size, config,
                                      compute_visibility=True, tile_front=True)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    front = runs[0][-1]
    plain = forward.rasterize_tiles_plain(pts, f, mapping, config,
                                          front_image_size=size)[-1]
    bins = mapping.tile_ranges[:, 1] - mapping.tile_ranges[:, 0]
    differ = int((front != plain).sum())
    assert differ <= max(1, int(0.01 * int((bins > 0).sum()))), differ
    assert (front[bins == 0] == 0).all()
