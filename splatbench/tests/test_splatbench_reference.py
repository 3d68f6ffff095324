"""The plain reference against the port's plain CPU path on small scenes,
for every entry the benchmark drives, and the frozen scene generators
against the port's."""


import pytest
import torch

from splatbench import harness, reference, runner, scenes
from splatbench.tests import small
import taichi_gaussian_rasterizer_tpu_torch as tgr
from taichi_gaussian_rasterizer_tpu_torch.optim import FractionalAdam, ParameterClass
from taichi_gaussian_rasterizer_tpu_torch.utils import random_data


def test_generators_equal_the_ports():
  for seed in (0, 2**35 + 3):
    a = torch.Generator().manual_seed(seed)
    b = torch.Generator().manual_seed(seed)
    cam = scenes.random_camera(a, image_size=(97, 61))
    cam_p = random_data.random_camera(b, image_size=(97, 61))
    assert torch.equal(cam["projection"], cam_p.projection)
    assert torch.equal(cam["T_camera_world"], cam_p.T_camera_world)
    for make, make_p in ((scenes.random_3d_gaussians, random_data.random_3d_gaussians),
                         (scenes.trained_like_gaussians,
                          random_data.trained_like_gaussians)):
      g = make(a, 700, cam)
      g_p = make_p(b, 700, cam_p)
      for k in scenes.GAUSSIAN_KEYS:
        assert torch.equal(g[k], getattr(g_p, k)), k


def _scene(name, field):
  cell = small.small_cell(name, field=field)
  camera, g = scenes.make_scene(cell.config, 99, "cpu")
  path = scenes.camera_path(camera, 4, 5.0, 0.05 * scenes.median_depth(g, camera), 0, 99)
  return cell.config, g, path[2]


@pytest.mark.parametrize("name,field", [("bicycle6m.serve", False),
                                        ("bicycle6m.serve", True)])
def test_render_matches_the_port(name, field):
  cfg, g, cam = _scene(name, field)
  r = reference.render(g, cam, cfg)
  out = tgr.render_gaussians(runner.to_gaussians(tgr, g), runner.to_camera(tgr, cam),
                             tgr.RasterConfig(), use_sh=cfg["features"]["kind"] == "sh",
                             render_depth=cfg["render_depth"])
  torch.testing.assert_close(out.image, r["image"], rtol=0, atol=2e-6)
  torch.testing.assert_close(out.image_weight, r["weight"], rtol=0, atol=2e-6)
  if cfg["render_depth"]:
    torch.testing.assert_close(out.depth, r["depth"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,field", [("bicycle6m.train", False),
                                        ("bicycle6m.train", True)])
def test_loss_and_gradients_match_the_port(name, field):
  cfg, g, cam = _scene(name, field)
  loss_fn = harness.load_part("losses", cfg["loss"]).loss
  channels = 3 if cfg["features"]["kind"] == "sh" else cfg["features"]["channels"]
  channels += harness.load_part("losses", cfg["loss"]).EXTRA_CHANNELS
  target = runner.make_target(cfg, channels, 5, 0, "cpu")
  loss, grads = reference.loss_and_grads(g, cam, cfg, loss_fn, target)
  leaves = {k: v.detach().clone().requires_grad_() for k, v in g.items()}
  out = tgr.render_gaussians(tgr.Gaussians3D(**leaves), runner.to_camera(tgr, cam),
                             tgr.RasterConfig(), use_sh=cfg["features"]["kind"] == "sh",
                             render_depth=cfg["render_depth"])
  loss_p = loss_fn(out.image, out.depth, target)
  loss_p.backward()
  assert abs(float(loss_p.detach()) - float(loss)) <= 1e-6 * abs(float(loss))
  for k in scenes.GAUSSIAN_KEYS:
    err = float((leaves[k].grad - grads[k]).norm() / grads[k].norm())
    assert err < 1e-4, (k, err)


def test_adam_matches_the_ports_fractional_adam():
  gen = torch.Generator().manual_seed(3)
  params = {k: torch.randn((500,) + s, generator=gen)
            for k, s in (("position", (3,)), ("feature", (3, 16)))}
  lrs = {"position": 0.01, "feature": 0.002}
  ref = reference.FractionalAdam(params, lrs)
  port = ParameterClass.create({k: v.clone() for k, v in params.items()},
                               {k: {"lr": v} for k, v in lrs.items()},
                               optimizer=FractionalAdam)
  ones = torch.ones(500)
  for _ in range(3):
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    ref.step(grads)
    port.step(grads, weight=ones)
  for k in params:
    torch.testing.assert_close(port.tensors[k], ref.params[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,field", [("bicycle6m.serve", False),
                                        ("bicycle6m.train", True),
                                        ("bicycle6m.train", False),
                                        ("bicycle6m.dp4-train", False)])
def test_every_entry_agrees_with_the_reference(name, field):
  cell = small.small_cell(name, field=field)
  _, numbers, _ = small.run(cell)
  assert all(v < 1e-4 for v in numbers.values()), numbers
