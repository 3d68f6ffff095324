"""SH shading (`ops/sh.py`): on the card, the kernels of `csrc/sh.cu`
against the plain version; on the CPU, the dispatch and the autograd
Function's glue. Card tests are marked `cuda` and skip without an NVIDIA
GPU. This file imports no JAX; on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_sh.py

Tolerances, kernel against plain on the same inputs:

* colours: |diff| <= 1e-5 in float32 (1e-13 in float64). The two add the
  K <= 16 products c_k Y_k (each at most 0.5 * 0.75 in size here) in
  different orders, and the kernel contracts the basis polynomials into
  fused multiply-adds: a few ulps of each term, about 2e-6 at the worst.
* d_sh = g * gate * Y_k: one product of the same basis value, so
  |diff| <= 1e-6 in float32 (1e-14 in float64), g in [-1, 1]. Rows whose
  pre-clamp colour lies within the colour tolerance of 0 or 1 may be
  gated differently by the two roundings; they are left out of the
  comparison (and of the points' position gradients) and must be rare.
* d_position: a sum of C * K terms g c dY/dd, chained through the
  normalisation: |diff| <= 4e-5 (1e-12 in float64) times the point's
  bound sum_c |g_c| sum_k |c_ck| * 4.6 / r (|dY_k/dd_j| <= 4.6; r the
  distance to the camera), which allows a few ulps of every term.
"""

import dataclasses
import math

import pytest
import torch

import taichi_gaussian_rasterizer_tpu_torch as tgr
from taichi_gaussian_rasterizer_tpu_torch.ops import lib, sh as sh_ops
from taichi_gaussian_rasterizer_tpu_torch.utils import random_data, tracing

TOL = {torch.float32: dict(color=1e-5, d_sh=1e-6, d_pos=4e-5),
       torch.float64: dict(color=1e-13, d_sh=1e-14, d_pos=1e-12)}


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def inputs(n, c, degree, dtype, device="cpu", seed=0):
  """Seeded (sh (N, C, K), positions (N, 3), camera (3,)); point 0 sits
  at the camera (the zero direction)."""
  gen = torch.Generator().manual_seed(seed)
  sh = torch.rand((n, c, (degree + 1) ** 2), generator=gen,
                  dtype=torch.float64) - 0.5
  pos = torch.randn((n, 3), generator=gen, dtype=torch.float64) * 4
  cam = torch.randn(3, generator=gen, dtype=torch.float64)
  pos[0] = cam
  return tuple(t.to(device=device, dtype=dtype) for t in (sh, pos, cam))


def pre_clamp(sh, pos, cam):
  """The plain version's colour before the clamp, in float64."""
  sh, pos, cam = (t.detach().double() for t in (sh, pos, cam))
  d = lib.safe_normalize(pos - cam)
  basis = sh_ops.rsh_cart(d, sh_ops.check_sh_degree(sh))
  return torch.einsum("nck,nk->nc", sh, basis) + 0.5


def plain_grads(sh, pos, cam, grad, wrt):
  """The plain version's colour and autograd's gradients wrt the named
  inputs (None for the others)."""
  leaves = {name: t.detach().clone().requires_grad_(name in wrt)
            for name, t in (("sh", sh), ("pos", pos), ("cam", cam))}
  color = sh_ops.evaluate_sh_plain(leaves["sh"], leaves["pos"], leaves["cam"])
  if wrt:
    (color * grad).sum().backward()
  return color.detach(), {k: v.grad for k, v in leaves.items()}


# -- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_cpu_takes_the_plain_path(degree):
  sh, pos, cam = inputs(300, 3, degree, torch.float32)
  before = (sh_ops.SH_FORWARD.launch_count, sh_ops.SH_BACKWARD.launch_count)
  sh.requires_grad_()
  got = tgr.evaluate_sh_at(sh, pos, cam)
  got.sum().backward()
  assert (sh_ops.SH_FORWARD.launch_count,
          sh_ops.SH_BACKWARD.launch_count) == before
  assert torch.equal(got, sh_ops.evaluate_sh_plain(sh, pos, cam))
  assert got.shape == (300, 3) and sh.grad is not None


def fake_forward(sh, positions, camera_pos, gate):
  """The forward kernel's contract in plain torch."""
  x = pre_clamp(sh, positions, camera_pos).to(sh.dtype)
  mask = ((x >= 0) & (x <= 1)).to(torch.uint8) if gate else None
  return torch.clamp(x, 0.0, 1.0), mask


def fake_backward(grad, mask, positions, camera_pos, sh, k, want_sh, calls):
  """The backward kernel's contract in plain torch: d_sh and each row's
  share of d(position - camera)."""
  calls.append(dict(want_sh=want_sh, with_sh=sh is not None,
                    mask_dtype=mask.dtype))
  degree = math.isqrt(k) - 1
  g = torch.where(mask.bool(), grad, torch.zeros_like(grad))
  v = positions - camera_pos
  sq = (v * v).sum(-1)
  ok = sq > 1e-32
  r = torch.where(ok, sq.sqrt(), torch.ones_like(sq))
  d = torch.where(ok[:, None], v / r[:, None], torch.zeros_like(v))
  basis = sh_ops.rsh_cart(d, degree)
  d_sh = g[:, :, None] * basis[:, None, :] if want_sh else None
  d_dir = None
  if sh is not None:
    jac = torch.func.vmap(torch.func.jacrev(
        lambda u: sh_ops.rsh_cart(u, degree)))(d)               # (N, K, 3)
    gd = g[:, :, None] * torch.einsum("nck,nkj->ncj", sh, jac)
    along = (d[:, None, :] * gd).sum(-1, keepdim=True)
    d_dir = torch.where(ok[:, None, None], (gd - d[:, None, :] * along)
                        / r[:, None, None], torch.zeros_like(gd))
  return d_sh, d_dir


@pytest.fixture
def fake_kernels(monkeypatch):
  """The CUDA path's Python on CPU tensors, the kernels replaced by their
  contracts in plain torch; returns the backward's calls."""
  calls = []
  monkeypatch.setattr(sh_ops, "_launch_forward", fake_forward)
  monkeypatch.setattr(
      sh_ops, "_launch_backward",
      lambda *args: fake_backward(*args, calls=calls))
  return calls


@pytest.mark.parametrize("wrt", [("sh",), ("pos",), ("sh", "pos"), ("cam",),
                                 ("sh", "pos", "cam")])
def test_function_routes_the_gradients_it_is_asked_for(fake_kernels, wrt):
  sh, pos, cam = inputs(400, 3, 3, torch.float64, seed=3)
  grad = torch.rand((400, 3), dtype=torch.float64) * 2 - 1
  want_color, want = plain_grads(sh, pos, cam, grad, wrt)
  leaves = {name: t.clone().requires_grad_(name in wrt)
            for name, t in (("sh", sh), ("pos", pos), ("cam", cam))}
  color = sh_ops.evaluate_sh_cuda(leaves["sh"], leaves["pos"], leaves["cam"])
  # nothing of (N, K) is saved: the positions, camera, gate and, for the
  # position's gradient, the coefficients themselves
  saved = [t for t in color.grad_fn.saved_tensors if t is not None]
  assert not any(t.shape == (400, 16) for t in saved)
  assert sum(t.dtype == torch.uint8 for t in saved) == 1
  (color * grad).sum().backward()
  torch.testing.assert_close(color, want_color, rtol=0, atol=1e-12)
  for name, leaf in leaves.items():
    if name in wrt:
      torch.testing.assert_close(leaf.grad, want[name], rtol=1e-10, atol=1e-10)
    else:
      assert leaf.grad is None, name
  assert fake_kernels == [dict(want_sh="sh" in wrt,
                               with_sh="pos" in wrt or "cam" in wrt,
                               mask_dtype=torch.uint8)]


def test_function_writes_no_gate_without_a_gradient(monkeypatch):
  seen = []

  def forward(sh, positions, camera_pos, gate):
    seen.append(gate)
    return fake_forward(sh, positions, camera_pos, gate)

  monkeypatch.setattr(sh_ops, "_launch_forward", forward)
  sh, pos, cam = inputs(50, 3, 2, torch.float32)
  sh.requires_grad_()
  with torch.no_grad():
    color = sh_ops.evaluate_sh_cuda(sh, pos, cam)
  assert color.grad_fn is None
  sh_ops.evaluate_sh_cuda(sh.detach(), pos, cam)
  sh_ops.evaluate_sh_cuda(sh, pos, cam)
  assert seen == [False, False, True]


@pytest.mark.parametrize("case", ["half", "mixed", "shape", "degree4", "cpu"])
def test_kernel_inputs_are_checked(case):
  """`evaluate_sh_cuda` on CPU tensors, so before any build: a dtype the
  kernels do not take, or two float types, raise TypeError; a shape they
  do not take raises ValueError, and so do float32 inputs on the CPU."""
  sh, pos, cam = inputs(10, 3, 3, torch.float32)
  error, match = ValueError, None
  if case == "half":
    sh, pos, cam = sh.half(), pos.half(), cam.half()
    error, match = TypeError, "float32 or float64"
  elif case == "mixed":
    cam = cam.double()
    error, match = TypeError, "camera"
  elif case == "shape":
    pos = pos[:9]
  elif case == "degree4":
    sh = torch.zeros(10, 3, 25)
  else:
    match = "CUDA tensors"
  with pytest.raises(error, match=match):
    sh_ops.evaluate_sh_cuda(sh, pos, cam)


def test_kernel_inputs_are_contiguous_and_aligned():
  sh, pos, cam = inputs(10, 3, 3, torch.float32)
  # a view one float into its storage: contiguous, not 16-byte aligned
  flat = torch.zeros(sh.numel() + 1)
  view = flat[1:].view(sh.shape)
  view.copy_(sh)
  got, got_pos, _ = sh_ops._kernel_inputs(view, pos.T.contiguous().T, cam)
  assert got.data_ptr() % 16 == 0 and torch.equal(got, sh)
  assert got_pos.is_contiguous()


# -- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 1000, 100003])
@pytest.mark.parametrize("c", [1, 3, 34])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_kernels_match_plain(cuda_device, degree, c, n, dtype):
  """Colours and d_sh from the kernels against the plain version; the
  rows whose gate may differ by rounding are left out."""
  device = cuda_device
  sh, pos, cam = inputs(n, c, degree, dtype, device, seed=n + c + degree)
  grad = torch.rand((n, c), dtype=dtype, device=device) * 2 - 1
  want_color, want = plain_grads(sh, pos, cam, grad, ("sh",))
  tol = TOL[dtype]
  x = pre_clamp(sh, pos, cam)
  sure = (x.abs() > tol["color"]) & ((x - 1).abs() > tol["color"])
  assert (~sure).double().mean() < 1e-3
  counts = (sh_ops.SH_FORWARD.launch_count, sh_ops.SH_BACKWARD.launch_count)
  leaf = sh.clone().requires_grad_()
  color = tgr.evaluate_sh_at(leaf, pos, cam)
  (color * grad).sum().backward()
  torch.cuda.synchronize()
  assert (sh_ops.SH_FORWARD.launch_count,
          sh_ops.SH_BACKWARD.launch_count) == (counts[0] + 1, counts[1] + 1)
  assert color.shape == (n, c) and color.dtype == dtype
  assert (color - want_color).abs().max() <= tol["color"]
  assert (leaf.grad - want["sh"])[sure].abs().max() <= tol["d_sh"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [1, 3, 34])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_position_gradient_matches_plain(cuda_device, degree, c, dtype):
  n = 1000
  sh, pos, cam = inputs(n, c, degree, dtype, cuda_device, seed=degree + c)
  grad = torch.rand((n, c), dtype=dtype, device=cuda_device) * 2 - 1
  wrt = ("sh", "pos", "cam")
  _, want = plain_grads(sh, pos, cam, grad, wrt)
  # degree 0's basis is a constant: the plain version leaves no path to
  # the positions, whose gradient is zero
  for name, t in (("pos", pos), ("cam", cam)):
    if want[name] is None:
      want[name] = torch.zeros_like(t)
  leaves = [t.clone().requires_grad_() for t in (sh, pos, cam)]
  color = tgr.evaluate_sh_at(*leaves)
  (color * grad).sum().backward()
  tol = TOL[dtype]
  x = pre_clamp(sh, pos, cam)
  sure = ((x.abs() > tol["color"]) & ((x - 1).abs() > tol["color"])).all(1)
  r = (pos - cam).norm(dim=1).clamp(min=1e-16)
  bound = (grad.abs()[:, :, None] * sh.abs()).sum((1, 2)) * 4.6 / r
  diff = (leaves[1].grad - want["pos"]).abs().amax(1)
  assert (diff[sure] <= tol["d_pos"] * bound[sure]).all()
  assert torch.equal(leaves[1].grad[0], torch.zeros_like(cam))   # at the camera
  if sure.all():
    assert ((leaves[2].grad - want["cam"]).abs()
            <= tol["d_pos"] * bound.sum()).all()
  torch.testing.assert_close(leaves[0].grad[sure], want["sh"][sure], rtol=0,
                             atol=tol["d_sh"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_position_gradient_absent_when_detached(cuda_device, dtype):
  sh, pos, cam = inputs(1000, 3, 3, dtype, cuda_device)
  leaf = sh.clone().requires_grad_()
  pos_leaf = pos.clone().requires_grad_()
  color = tgr.evaluate_sh_at(leaf, pos_leaf.detach(), cam)
  assert not any(t is not None and t.shape == sh.shape
                 for t in color.grad_fn.saved_tensors)
  color.sum().backward()
  assert pos_leaf.grad is None and leaf.grad is not None


def coefficient(dtype, done, start: float) -> float:
  """The least coefficient s, scanning up one ulp at a time from 8 ulps
  below `start`, for which done(s * Y_0) holds in dtype."""
  y0 = torch.tensor(0.282094791773878, dtype=dtype)
  s = torch.tensor(start, dtype=dtype)
  up, down = torch.tensor(math.inf, dtype=dtype), torch.tensor(-math.inf, dtype=dtype)
  for _ in range(8):
    s = torch.nextafter(s, down)
  for _ in range(32):
    if done(s * y0):
      return float(s)
    s = torch.nextafter(s, up)
  raise AssertionError("no coefficient found")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [0, 3])
def test_clamp_gate_is_inclusive(cuda_device, degree, dtype):
  """Colours of exactly -0.5 and +0.5 before the clamp land on 0 and 1 and
  keep their gradient, as torch.clamp's; one ulp past +0.5 loses it."""
  sh, pos, cam = inputs(64, 3, degree, dtype, cuda_device)
  y0 = 0.282094791773878
  # one exists for +-0.5: the products of neighbouring s lie closer
  # together than the rounding interval around 0.5
  lo = coefficient(dtype, lambda p: p == -0.5, -0.5 / y0)
  hi = coefficient(dtype, lambda p: p == 0.5, 0.5 / y0)
  past = coefficient(dtype, lambda p: p + 0.5 > 1, 0.5 / y0)
  sh[1:4] = 0
  sh[1, :, 0], sh[2, :, 0], sh[3, :, 0] = lo, hi, past
  grad = torch.ones((64, 3), dtype=dtype, device=cuda_device)
  want_color, want = plain_grads(sh, pos, cam, grad, ("sh",))
  leaf = sh.clone().requires_grad_()
  color = tgr.evaluate_sh_at(leaf, pos, cam)
  color.sum().backward()
  assert (color[1] == 0).all() and (color[2] == 1).all() and (color[3] == 1).all()
  assert torch.equal(color[1:4], want_color[1:4])
  assert (leaf.grad[1:3, :, 0] != 0).all() and (leaf.grad[3] == 0).all()
  assert torch.equal(leaf.grad[1:4] != 0, want["sh"][1:4] != 0)


@pytest.mark.cuda
def test_cuda_launches_or_raises(cuda_device, monkeypatch):
  def refuse(*args, **kwargs):
    raise AssertionError("the plain version ran on CUDA tensors")

  monkeypatch.setattr(sh_ops, "evaluate_sh_plain", refuse)
  sh, pos, cam = inputs(100, 3, 3, torch.float32, cuda_device)
  before = sh_ops.SH_FORWARD.launch_count
  tgr.evaluate_sh_at(sh, pos, cam, indexes=torch.arange(0, 100, 3,
                                                        device=cuda_device))
  assert sh_ops.SH_FORWARD.launch_count == before + 1
  with pytest.raises(TypeError):
    tgr.evaluate_sh_at(sh.half(), pos.half(), cam.half())
  with pytest.raises(TypeError):
    tgr.evaluate_sh_at(sh, pos, cam.double())


@pytest.mark.cuda
def test_sh_spans_on_card(cuda_device):
  """A training frame on the card: tgr.sh counts every row as the
  kernel's, and tgr.sh.bwd lies inside tgr.project.bwd, in the frame."""
  gen = torch.Generator(device=cuda_device).manual_seed(5)
  cam = random_data.random_camera(gen, image_size=(64, 48))
  g = random_data.random_3d_gaussians(gen, 300, cam, sh_degree=3)
  g = tgr.Gaussians3D(**{f.name: getattr(g, f.name).detach().requires_grad_()
                         for f in dataclasses.fields(g)})
  tracing.clear()
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    r = tgr.render_gaussians(g, cam, tgr.RasterConfig(tile_size=16), use_sh=True)
    r.image.abs().mean().backward()
  torch.cuda.synchronize()
  recs = {rec["name"]: rec for rec in tracing.records()}
  tracing.clear()
  shade, bwd, tail = recs["tgr.sh"], recs["tgr.sh.bwd"], recs["tgr.project.bwd"]
  assert shade["counts"] == dict(points=300, kernel_points=300)
  assert bwd["parent"] == shade["id"] and bwd["frame"] == tail["frame"]
  assert tail["start_ns"] <= bwd["start_ns"] <= bwd["end_ns"] <= tail["end_ns"]
  assert bwd["device_ms"] is not None
