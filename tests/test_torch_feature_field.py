"""Feature 3DGS on the port, on the CPU at a small size, against the
benchmark's plain reference `splatbench/field_reference.py` (plain torch:
nothing of the port, nothing of JAX):

* `render_gaussians(use_sh=True, point_features=f)` blends the SH colour
  and f in one raster pass; the colour image, the feature map and the
  weight match the plain joint blend (float64: atol 1e-9, the sums' own
  rounding in two summation orders), at 3 + 20 and 3 + 128 channels;
* the whole Feature 3DGS loss (the blend, the decoder's resize and 1x1
  convolution, L1 on both) and its gradients in every `Gaussians3D` leaf,
  in the point features and in the decoder's W and b match the plain
  loss's (float64: the loss to 1e-12 relative, each gradient to 1e-8 of
  its norm);
* the decoder alone, its resize up and down, against the plain one
  (float64, 1e-12) and gradcheck;
* the reduction of the feature field's 137 rows equals the gather into
  point order and the segment sum, bit for bit;
* `point_features=None` renders what the render's own pieces render,
  bit for bit, with one raster launch of the colour's 3 channels;
* the decoder's spans and counts, and the raster's and the reduction's
  counts, under a CPU profile;
* the plain reference's TF32 control differs from it, and the reference
  loads neither JAX nor the port.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import taichi_gaussian_rasterizer_tpu_torch as tgr
from taichi_gaussian_rasterizer_tpu_torch.models import FeatureDecoder, decode_features
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import function
from taichi_gaussian_rasterizer_tpu_torch.ops.raster.reduce import \
    segment_sums_by_sorted_key
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing

from splatbench import field_reference as plain
from splatbench import scenes

ROOT = Path(__file__).resolve().parents[1]
SIZE = (64, 48)
TEACHER = (40, 30)     # (W', H'): the teacher's map, smaller than the frame
KEYS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


def config(channels):
  return dict(render_depth=False, features={"kind": "sh", "sh_degree": 3},
              raster_config={"tile_size": 16},
              field={"channels": channels, "decoded_channels": 24,
                     "teacher_size": list(TEACHER), "feature_loss_weight": 1.0})


def scene(channels, dtype=torch.float64, n=300, seed=3):
  """A camera dict, the gaussians (SH degree 3), the semantic features,
  the decoder's W and b, a colour target and a unit-vector teacher map."""
  gen = torch.Generator().manual_seed(seed)
  cam = scenes.random_camera(gen, image_size=SIZE, dtype=dtype)
  g = scenes.trained_like_gaussians(gen, n, cam, dtype=dtype)
  g["feature"] = torch.rand((n, 3, 16), generator=gen, dtype=dtype) - 0.5
  g["feature"][..., 1:] *= 0.1
  semantic = torch.rand((n, channels), generator=gen, dtype=dtype) - 0.5
  bound = channels ** -0.5
  dec = {"decoder_weight": (torch.rand((24, channels), generator=gen, dtype=dtype)
                            * 2 - 1) * bound,
         "decoder_bias": (torch.rand((24,), generator=gen, dtype=dtype) * 2 - 1) * bound}
  target = torch.rand((SIZE[1], SIZE[0], 3), generator=gen, dtype=dtype)
  teacher = torch.randn((TEACHER[1], TEACHER[0], 24), generator=gen, dtype=dtype)
  teacher = teacher / teacher.norm(dim=-1, keepdim=True)
  return cam, g, semantic, dec, target, teacher


def port_camera(cam):
  return tgr.CameraParams(projection=cam["projection"],
                          T_camera_world=cam["T_camera_world"],
                          near_plane=cam["near_plane"], far_plane=cam["far_plane"],
                          image_size=cam["image_size"])


@pytest.fixture(autouse=True)
def empty_buffer():
  tracing.clear()
  yield
  tracing.clear()


@pytest.mark.parametrize("channels", [20, 128])
def test_joint_render_matches_plain(channels):
  cam, g, semantic, *_ = scene(channels)
  r = tgr.render_gaussians(tgr.Gaussians3D(**g), port_camera(cam), tgr.RasterConfig(),
                           use_sh=True, point_features=semantic)
  want = plain.render_joint(g, semantic, cam, config(channels))
  assert r.image.shape == (SIZE[1], SIZE[0], 3)
  assert r.feature_map.shape == (SIZE[1], SIZE[0], channels)
  assert want["active"] > 0
  for got, ref in ((r.image, want["image"]), (r.feature_map, want["feature_map"]),
                   (r.image_weight, want["weight"])):
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-9)


def _port_loss(g, semantic, dec, cam, target, teacher):
  leaves = {k: v.detach().clone().requires_grad_() for k, v in g.items()}
  sem = semantic.detach().clone().requires_grad_()
  w = dec["decoder_weight"].detach().clone().requires_grad_()
  b = dec["decoder_bias"].detach().clone().requires_grad_()
  r = tgr.render_gaussians(tgr.Gaussians3D(**leaves), port_camera(cam),
                           tgr.RasterConfig(), use_sh=True, point_features=sem)
  decoded = decode_features(r.feature_map, w, b, TEACHER[::-1])
  loss = (torch.mean(torch.abs(r.image - target))
          + torch.mean(torch.abs(decoded - teacher)))
  loss.backward()
  grads = {k: leaves[k].grad for k in KEYS}
  grads.update(semantic_feature=sem.grad, decoder_weight=w.grad, decoder_bias=b.grad)
  return loss.detach(), grads


@pytest.mark.parametrize("channels", [20, 128])
def test_loss_and_gradients_match_plain(channels):
  cam, g, semantic, dec, target, teacher = scene(channels)
  loss, grads = _port_loss(g, semantic, dec, cam, target, teacher)
  want, want_grads = plain.loss_and_grads(dict(g, semantic_feature=semantic), dec,
                                          cam, config(channels), target, teacher)
  assert abs(float(loss) - float(want)) <= 1e-12 * abs(float(want))
  assert set(grads) == set(want_grads)
  for k, ref in want_grads.items():
    assert float(ref.norm()) > 0, k
    err = float((grads[k] - ref).norm() / ref.norm())
    assert err < 1e-8, (k, err)


@pytest.mark.parametrize("size", [(30, 40), (61, 77)])
def test_decoder_matches_plain_resize_and_product(size):
  gen = torch.Generator().manual_seed(11)
  fmap = torch.randn((SIZE[1], SIZE[0], 9), generator=gen, dtype=torch.float64)
  w = torch.randn((5, 9), generator=gen, dtype=torch.float64)
  b = torch.randn((5,), generator=gen, dtype=torch.float64)
  got = decode_features(fmap, w, b, size)
  torch.testing.assert_close(got, plain.decode(fmap, w, b, size), rtol=0, atol=1e-12)
  resized = F.interpolate(fmap.permute(2, 0, 1)[None], size=size, mode="bilinear",
                          align_corners=True)[0].permute(1, 2, 0)
  torch.testing.assert_close(plain.resize(fmap, size), resized, rtol=0, atol=1e-12)
  # a strided map, as a slice of the joint image is, and every gradient
  joint = torch.randn((11, 13, 12), generator=gen, dtype=torch.float64)
  args = (joint[..., 3:].requires_grad_(), w.requires_grad_(), b.requires_grad_())
  assert torch.autograd.gradcheck(lambda m, w_, b_: decode_features(m, w_, b_, (7, 5)),
                                  args)
  decoder = FeatureDecoder(9, 5)
  assert decoder.weight.abs().max() <= 9 ** -0.5
  assert decoder(fmap.float(), size).shape == (size[0], size[1], 5)


def test_chunked_reduction_equals_one_shot_bit_for_bit():
  cam, g, *_ = scene(128, dtype=torch.float32)
  points, depths, _ = tgr.project_to_image(tgr.Gaussians3D(**g), port_camera(cam),
                                           tgr.RasterConfig())
  near, far = cam["near_plane"], cam["far_plane"]
  mapping = tgr.map_to_tiles(points, tgr.ops.lib.ndc_depth(
      torch.clamp(depths, min=near), near, far)[:, 0], SIZE, tgr.RasterConfig())
  k = mapping.overlap_to_point.shape[0]
  assert k > 0
  rows = 6 + 3 + 128
  slots = torch.randn((rows, k), generator=torch.Generator().manual_seed(2))
  got = function.reduce_slots_by_point(slots, mapping)
  keys, order = torch.sort(mapping.overlap_to_point, stable=True)
  want = segment_sums_by_sorted_key(keys, slots.index_select(1, order),
                                    mapping.point_offsets, mapping.point_sentinel).T
  assert got.shape == want.shape == (mapping.point_sentinel, rows)
  assert torch.equal(got, want)


def test_no_point_features_renders_as_before(monkeypatch):
  cam, g, *_ = scene(20, dtype=torch.float32)
  gauss, camera, cfg = tgr.Gaussians3D(**g), port_camera(cam), tgr.RasterConfig()
  widths = []
  original = function.rasterize_forward

  def counted(points, features, *args, **kwargs):
    widths.append(features.shape[1])
    return original(points, features, *args, **kwargs)

  monkeypatch.setattr(function, "rasterize_forward", counted)
  r = tgr.render_gaussians(gauss, camera, cfg, use_sh=True)
  r_none = tgr.render_gaussians(gauss, camera, cfg, use_sh=True, point_features=None)
  assert widths == [3, 3]
  # what the render's own pieces give
  points, depths, in_view = tgr.project_to_image(gauss, camera, cfg)
  colour = tgr.evaluate_sh_at(gauss.feature, gauss.position, camera.camera_position)
  near, far = camera.near_plane, camera.far_plane
  mapping = tgr.map_to_tiles(points, tgr.ops.lib.ndc_depth(
      torch.clamp(depths, min=near), near, far)[:, 0], SIZE, cfg)
  out = tgr.rasterize_with_tiles(points, colour, mapping, SIZE, cfg)
  for got in (r, r_none):
    assert got.feature_map is None
    assert torch.equal(got.image, out.image)
    assert torch.equal(got.image_weight, out.image_weight)
    assert torch.equal(got.points_in_view, in_view)


def test_point_features_with_depth_and_raw_features():
  """The feature map rides after raw features too, and after the depth
  channels: each part equals its own render."""
  cam, g, semantic, *_ = scene(20, dtype=torch.float64)
  g = dict(g, feature=torch.rand((300, 4), generator=torch.Generator().manual_seed(1),
                                 dtype=torch.float64))
  gauss, camera, cfg = tgr.Gaussians3D(**g), port_camera(cam), tgr.RasterConfig()
  joint = tgr.render_gaussians(gauss, camera, cfg, render_depth=True,
                               point_features=semantic)
  alone = tgr.render_gaussians(gauss, camera, cfg, render_depth=True)
  field = tgr.render_gaussians(dataclasses.replace(gauss, feature=semantic), camera, cfg)
  torch.testing.assert_close(joint.image, alone.image, rtol=0, atol=1e-12)
  torch.testing.assert_close(joint.depth, alone.depth, rtol=0, atol=1e-12)
  torch.testing.assert_close(joint.feature_map, field.image, rtol=0, atol=1e-12)
  with pytest.raises(ValueError, match="point_features"):
    tgr.render_gaussians(gauss, camera, cfg, point_features=semantic[:-1])


def test_spans_and_counts_under_a_profile():
  cam, g, semantic, dec, target, teacher = scene(128, dtype=torch.float32)
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    _port_loss(g, semantic, {k: v.float() for k, v in dec.items()}, cam,
               target.float(), teacher.float())
  recs = tracing.records()
  by = {}
  for r in recs:
    by.setdefault(r["name"], []).append(r)
  fwd, = by["tgr.field.decode"]
  bwd, = by["tgr.field.decode.bwd"]
  counts = dict(pixels=TEACHER[0] * TEACHER[1], in_channels=128, out_channels=24)
  assert fwd["counts"] == counts and bwd["counts"] == counts
  assert bwd["parent"] == fwd["id"] and bwd["frame"] == fwd["frame"]
  assert fwd["device_ms"] is None      # no CUDA on the CPU
  raster, = by["tgr.raster.fwd"]
  assert raster["counts"] == {"channels": 131}
  sorts = by["tgr.reduce.sort"]
  assert len(sorts) == 1 + 1          # the sort, then the gather and sums
  # the plain CPU path: no row reduced by the kernel
  assert sorts[0]["counts"] == {"rows": 137, "chunks": 1, "kernel_rows": 0}
  assert all(s["frame"] == raster["frame"] for s in sorts)


def test_the_reference_loads_neither_jax_nor_the_port():
  cam, g, semantic, dec, target, teacher = scene(20, dtype=torch.float32, seed=8)
  gs = dict(g, semantic_feature=semantic)
  a = plain.loss_and_grads(gs, dec, cam, config(20), target, teacher)
  ta = plain.loss_and_grads(gs, dec, cam, config(20), target, teacher, tf32=True)
  assert float(ta[0]) != float(a[0])
  assert any(not torch.equal(a[1][k], ta[1][k]) for k in a[1])
  code = ("import sys; sys.path[:0] = [{root!r}]\n"
          "import splatbench.field_reference\n"
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'taichi_gaussian_rasterizer_tpu', "
          "'taichi_gaussian_rasterizer_tpu_torch')]\n"
          "assert not bad, bad\n").format(root=str(ROOT))
  out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
  assert out.returncode == 0, out.stderr
