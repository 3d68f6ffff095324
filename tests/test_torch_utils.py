"""The port's utilities against the JAX package's: `ops.indexing`,
`ops.lib`, `ops.mapper.pad_to_tile`, `utils.random_data.
trained_like_gaussians`, `utils.checkpoint` and `utils.runtime`; and a
check that no module of the port imports JAX.

Tolerances: the lib functions float64, atol 1e-12 (the same formulas);
indexing, sorts and checkpoints exact.
"""

import ast
import ctypes
import dataclasses
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_gaussian_rasterizer_tpu.io import native as jax_native
from taichi_gaussian_rasterizer_tpu.ops import indexing as jax_indexing
from taichi_gaussian_rasterizer_tpu.ops import lib as jax_lib
from taichi_gaussian_rasterizer_tpu.ops.mapper import pad_to_tile as jax_pad_to_tile

import taichi_gaussian_rasterizer_tpu_torch as tgr
from taichi_gaussian_rasterizer_tpu_torch.ops import (
    index_features, lib, mask_features, segmented_sort_pairs)
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import probe_visit_chunks
from taichi_gaussian_rasterizer_tpu_torch.optim import FractionalAdam, ParameterClass
from taichi_gaussian_rasterizer_tpu_torch.utils import (
    checkpoint, cuda_build, random_data, runtime)

REPO = Path(__file__).resolve().parents[1]

# ---- indexing -------------------------------------------------------------


def test_segmented_sort_matches_jax_device_on_full_coverage():
  rng = np.random.default_rng(0)
  n = 4096
  keys = rng.integers(0, 50, size=n).astype(np.uint32)     # many ties
  vals = np.arange(n, dtype=np.int32)
  offsets = np.concatenate([[0], np.sort(rng.choice(np.arange(1, n), 40,
                                                    replace=False)), [n]])
  jk, jv = jax_indexing.segmented_sort_pairs(
      jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(offsets))
  k, v = segmented_sort_pairs(torch.from_numpy(keys.astype(np.int64)),
                              torch.from_numpy(vals), torch.from_numpy(offsets))
  np.testing.assert_array_equal(k.numpy(), np.asarray(jk, np.int64))
  np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", ["advice", "random"])
def test_segmented_sort_keeps_the_host_contract(case):
  """Partial coverage: rows outside [offsets[0], offsets[-1]) keep their
  place, as in the host version (`io.native`). The JAX device version
  sorts them into the edge segments and differs here."""
  if case == "advice":
    keys = np.array([9, 1, 5, 3, 8, 2], np.uint32)
    offsets = np.array([2, 5])
  else:
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1000, size=500).astype(np.uint32)
    offsets = np.array([37, 90, 90, 211, 460])
  vals = np.arange(len(keys), dtype=np.int32)
  hk, hv = jax_native.segmented_sort_pairs(keys, vals, offsets)
  k, v = segmented_sort_pairs(torch.from_numpy(keys.astype(np.int64)),
                              torch.from_numpy(vals), torch.from_numpy(offsets))
  np.testing.assert_array_equal(k.numpy(), hk.astype(np.int64))
  np.testing.assert_array_equal(v.numpy(), hv)
  if case == "advice":
    assert k.tolist() == [9, 1, 3, 5, 8, 2]
  dk, _ = jax_indexing.segmented_sort_pairs(
      jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(offsets))
  assert not np.array_equal(np.asarray(dk, np.int64), k.numpy())


def test_index_and_mask_features():
  rng = np.random.default_rng(2)
  feats = rng.normal(size=(10, 3))
  idx = np.array([3, 3, 0, 9, 3])
  f = torch.tensor(feats, requires_grad=True)
  out = index_features(f, torch.tensor(idx))
  np.testing.assert_array_equal(out.detach().numpy(),
                                np.asarray(jax_indexing.index_features(
                                    jnp.asarray(feats), jnp.asarray(idx))))
  g = rng.normal(size=(5, 3))
  out.backward(torch.tensor(g))
  want = np.zeros_like(feats)
  np.add.at(want, idx, g)                       # the gradient is a scatter-add
  np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=1e-15)
  mask = np.array([True, False] * 5)
  np.testing.assert_array_equal(
      mask_features(torch.tensor(feats), torch.tensor(mask), 7.0).numpy(),
      np.asarray(jax_indexing.mask_features(jnp.asarray(feats),
                                            jnp.asarray(mask), 7.0)))


# ---- lib -------------------------------------------------------------------


def _lib_args(name, rng, n=64):
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  m = rng.normal(size=(n, 2, 2))
  cov_m = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(2)
  cov = np.stack([cov_m[:, 0, 0], cov_m[:, 0, 1], cov_m[:, 1, 1]], 1)
  cov[:4, 1] = 0.0                              # axis aligned
  cov[2:4, 2] = cov[2:4, 0]                     # isotropic
  xy, uv = rng.normal(size=(n, 2)) * 3, rng.normal(size=(n, 2))
  axis = rng.normal(size=(n, 2))
  axis /= np.linalg.norm(axis, axis=1, keepdims=True)
  return {
      "quat_mul": (q, rng.normal(size=(n, 4))),
      "quat_conj": (q,),
      "quat_rotate": (q, rng.normal(size=(n, 3))),
      "scaled_quat_to_mat": (q, rng.uniform(0.1, 2.0, size=(n, 3))),
      "upper": (cov_m,),
      "inverse_cov": (cov,),
      "eig": (cov,),
      "radii_from_cov": (cov,),
      "radii_from_conic": (cov,),
      "ellipse_bounds": (uv, rng.normal(size=(n, 2)), rng.normal(size=(n, 2))),
      "cov_axes": (cov,),
      "conic_pdf": (xy, uv, cov),
      "gaussian_pdf": (xy, uv, axis, rng.uniform(0.5, 3.0, size=(n, 2))),
  }[name]


@pytest.mark.parametrize("name", [
    "quat_mul", "quat_conj", "quat_rotate", "scaled_quat_to_mat", "upper",
    "inverse_cov", "eig", "radii_from_cov", "radii_from_conic",
    "ellipse_bounds", "cov_axes", "conic_pdf", "gaussian_pdf"])
def test_lib_matches_jax(name):
  args = _lib_args(name, np.random.default_rng(3))
  got = getattr(lib, name)(*(torch.tensor(a) for a in args))
  want = getattr(jax_lib, name)(*(jnp.asarray(a) for a in args))
  got = got if isinstance(got, tuple) else (got,)
  want = want if isinstance(want, tuple) else (want,)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert g.dtype == torch.float64
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_pad_to_tile_matches_jax():
  for size in [(62, 45), (64, 48), (1, 1), (2048, 1536)]:
    for ts in (8, 16, 32):
      assert tgr.pad_to_tile(size, ts) == jax_pad_to_tile(size, ts)


# ---- trained_like_gaussians -------------------------------------------------


def test_trained_like_gaussians_shapes_and_seed():
  gen = torch.Generator().manual_seed(0)
  camera = random_data.random_camera(gen, image_size=(64, 48))
  g = random_data.trained_like_gaussians(torch.Generator().manual_seed(5), 500,
                                         camera)
  again = random_data.trained_like_gaussians(torch.Generator().manual_seed(5),
                                             500, camera)
  shapes = dict(position=(500, 3), log_scaling=(500, 3), rotation=(500, 4),
                alpha_logit=(500, 1), feature=(500, 3))
  for f in dataclasses.fields(g):
    value = getattr(g, f.name)
    assert value.shape == shapes[f.name] and value.dtype == torch.float32
    assert torch.isfinite(value).all()
    assert torch.equal(value, getattr(again, f.name)), f.name
  g64 = random_data.trained_like_gaussians(
      torch.Generator().manual_seed(5), 10, camera, dtype=torch.float64)
  assert g64.position.dtype == torch.float64


def test_trained_like_gaussians_saturate_and_truncate():
  """At 20k points @640x480 the trained-like scene saturates a larger
  share of pixels than random_3d_gaussians, and the probe keeps fewer
  slots than the mapping holds."""
  size, n = (640, 480), 20_000
  gen = torch.Generator().manual_seed(0)
  camera = random_data.random_camera(gen, image_size=size)
  config = tgr.RasterConfig()
  saturated = {}
  for name in ("trained", "random"):
    make = (random_data.trained_like_gaussians if name == "trained"
            else random_data.random_3d_gaussians)
    g = make(torch.Generator().manual_seed(1), n, camera)
    with torch.no_grad():
      points, depths, _ = tgr.project_to_image(g, camera, config)
      ndc = lib.ndc_depth(torch.clamp(depths, min=camera.near_plane),
                          camera.near_plane, camera.far_plane)
      mapping = tgr.map_to_tiles(points, ndc[:, 0], size, config)
      out = tgr.rasterize_with_tiles(points, g.feature, mapping, size, config)
    saturated[name] = float((out.image_weight >= config.saturate_threshold)
                            .double().mean())
    if name == "trained":
      _, cap = probe_visit_chunks(points, mapping, config, margin_chunks=0)
      assert cap < mapping.overlap_to_point.shape[0]
  assert saturated["trained"] > 0.5 > saturated["random"], saturated


# ---- checkpoint ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bundle:
  gaussians: tgr.Gaussians3D
  extra: dict


def _tree():
  rng = np.random.default_rng(4)
  g = tgr.Gaussians3D(**{k: torch.tensor(rng.normal(size=s), dtype=torch.float32)
                         for k, s in dict(position=(5, 3), log_scaling=(5, 3),
                                          rotation=(5, 4), alpha_logit=(5, 1),
                                          feature=(5, 3, 4)).items()})
  return Bundle(g, {"step": 7, "lr": 1e-3, "name": "run", "none": None,
                    1: [torch.arange(3), (np.arange(4.0), True)]})


def _assert_same(a, b):
  if isinstance(a, torch.Tensor):
    assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
  elif isinstance(a, np.ndarray):
    assert isinstance(b, np.ndarray)
    np.testing.assert_array_equal(a, b)
  elif dataclasses.is_dataclass(a):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
      _assert_same(getattr(a, f.name), getattr(b, f.name))
  elif isinstance(a, dict):
    assert list(a) == list(b)
    for k in a:
      _assert_same(a[k], b[k])
  elif isinstance(a, (list, tuple)):
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
      _assert_same(x, y)
  else:
    assert a == b and type(a) is type(b)


@pytest.mark.parametrize("kind", ["file", "distributed"])
def test_checkpoint_round_trip(tmp_path, kind):
  tree = _tree()
  path = str(tmp_path / "ckpt")
  if kind == "file":
    checkpoint.save_checkpoint(path, tree)
    back = checkpoint.load_checkpoint(path, device="cpu")
  else:
    checkpoint.save_distributed(path, tree)
    back = checkpoint.load_distributed(path, device="cpu")
  _assert_same(tree, back)


@pytest.mark.parametrize("kind", ["file", "distributed"])
def test_parameter_class_state_dict_through_a_checkpoint(tmp_path, kind):
  rng = np.random.default_rng(5)
  p = ParameterClass.create(
      {"position": torch.tensor(rng.normal(size=(6, 3)), dtype=torch.float32),
       "alpha": torch.tensor(rng.normal(size=(6, 1)), dtype=torch.float32)},
      {"position": dict(lr=0.1, type="scalar"), "alpha": dict(lr=0.05, type="scalar")},
      optimizer=FractionalAdam)
  p.step({"position": torch.ones(6, 3)}, visibility=torch.ones(6))
  path = str(tmp_path / "params")
  save, load = ((checkpoint.save_checkpoint, checkpoint.load_checkpoint)
                if kind == "file" else
                (checkpoint.save_distributed, checkpoint.load_distributed))
  save(path, p.state_dict())
  q = ParameterClass.from_state_dict(load(path, device="cpu"), device="cpu")
  for k in p.tensors:
    assert torch.equal(q.tensors[k], p.tensors[k])
  for k in p.state:
    assert torch.equal(q.state[k].m, p.state[k].m)
    assert torch.equal(q.state[k].v, p.state[k].v)
  assert q.group_dict == p.group_dict and q.optimizer == p.optimizer


def test_checkpoint_refuses_unknown_leaves(tmp_path):
  with pytest.raises(TypeError):
    checkpoint.save_checkpoint(str(tmp_path / "x"), {"f": object()})


# ---- runtime ---------------------------------------------------------------


def test_check_finite_names_the_bad_leaves():
  runtime.check_finite({"a": torch.ones(3), "b": [torch.zeros(2)]}, "ok")
  tree = {"a": torch.tensor([1.0, math.nan, math.inf]),
          "b": [torch.tensor([0.0]), torch.tensor([1, 2])]}
  with pytest.raises(ValueError, match=r"params\['a'\]\": 2"):
    runtime.check_finite(tree, "params")


def test_debug_mode_sets_and_restores():
  assert not torch.is_anomaly_enabled() and not cuda_build.SYNC_AFTER_LAUNCH
  with runtime.debug_mode():
    assert torch.is_anomaly_enabled() and cuda_build.SYNC_AFTER_LAUNCH
  assert not torch.is_anomaly_enabled() and not cuda_build.SYNC_AFTER_LAUNCH
  with pytest.raises(KeyError):
    with runtime.debug_mode():
      raise KeyError("x")
  assert not torch.is_anomaly_enabled() and not cuda_build.SYNC_AFTER_LAUNCH


# ---- the Python-CUDA boundary ----------------------------------------------

_SIGNATURE = "real@16 x, real y, i32 index, u8? gate, int n, float scale"


def _launch_args(case):
  args = dict(x=torch.zeros(8), y=torch.zeros(8),
              index=torch.zeros(8, dtype=torch.int32),
              gate=torch.zeros(8, dtype=torch.uint8), n=8, scale=0.5)
  if case == "wrong_dtype":
    args["index"] = args["index"].long()
  elif case == "not_a_float_type":
    args["x"], args["y"] = args["x"].half(), args["y"].half()
  elif case == "mixed_float_types":
    args["y"] = args["y"].double()
  elif case == "none_required":
    args["index"] = None
  elif case == "none_optional":
    args["gate"] = None
  elif case == "strided":
    args["x"] = torch.zeros(16)[::2]
  elif case == "misaligned":
    args["x"] = torch.zeros(9)[1:]          # one float past a 64-byte boundary
  elif case == "int_too_large":
    args["n"] = 2 ** 31
  elif case == "float_for_int":
    args["n"] = 8.0
  elif case == "too_few":
    del args["scale"]
  return list(args.values())


@pytest.mark.parametrize("case,error,match", [
    ("wrong_dtype", TypeError, "tgr_test: index takes torch.int32, got torch.int64"),
    ("not_a_float_type", TypeError, "tgr_test: x takes float32 or float64"),
    ("mixed_float_types", TypeError, "tgr_test: y takes torch.float32, got torch.float64"),
    ("none_required", TypeError, "tgr_test: index is required"),
    ("none_optional", ValueError, "tgr_test: x is on cpu"),
    ("strided", ValueError, "tgr_test: x must be contiguous"),
    ("misaligned", ValueError, "tgr_test: x must be 16-byte aligned"),
    ("cpu", ValueError, "tgr_test: x is on cpu: tgr_test takes CUDA tensors"),
    ("int_too_large", ValueError, "tgr_test: n = 2147483648 does not fit"),
    ("float_for_int", TypeError, "cannot be interpreted as an integer"),
    ("too_few", TypeError, "tgr_test takes 6 arguments, got 5"),
])
def test_cuda_kernel_checks_every_argument_before_a_build(monkeypatch, case,
                                                          error, match):
  """`CudaKernel.launch` checks each argument against its slot of a
  declared signature, dtypes (TypeError) ahead of layout and device
  (ValueError), before anything is built or loaded: every case here
  raises on the CPU, and None in an optional slot gets past its slot to
  the device check."""
  def no_build(source):
    raise AssertionError(f"built {source}")

  monkeypatch.setattr(cuda_build, "build", no_build)
  kernel = cuda_build.CudaKernel("none.cu", "tgr_test", _SIGNATURE)
  with pytest.raises(error, match=match):
    kernel.launch(*_launch_args(case))
  assert kernel.launch_count == 0


def test_cuda_kernel_derives_its_argtypes(monkeypatch):
  """The ctypes argument types come from the signature: a pointer for
  every tensor slot and for the trailing stream, each scalar's C type; a
  signature with an unknown type is refused."""
  class Library:
    tgr_test = type("Entry", (), {})()
    tgr_error_string = type("Entry", (), {})()

  monkeypatch.setattr(cuda_build, "build", lambda source: ("lib.so", "log"))
  monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: Library)
  kernel = cuda_build.CudaKernel("none.cu", "tgr_test", _SIGNATURE)
  fn = kernel.load()
  p = ctypes.c_void_p
  assert fn.argtypes == [p, p, p, p, ctypes.c_int, ctypes.c_float, p]
  assert fn.restype is ctypes.c_int and kernel.build_log == "log"
  assert [s.name for s in kernel.slots] == ["x", "y", "index", "gate", "n", "scale"]
  assert [s.optional for s in kernel.slots] == [False, False, False, True, False, False]
  assert kernel.slots[0].align == 16 and kernel.slots[0].dtype is None
  with pytest.raises(ValueError, match="int64 n"):
    cuda_build.parse_signature("f32 x, int64 n")


# ---- the port imports no JAX -------------------------------------------------


def test_port_imports_no_jax():
  """Every module of the port, chip_smoke.py and the multi-rank tests'
  rank helper, parsed: no import of jax or of the JAX package (its
  docstrings name their counterparts, which is fine)."""
  files = sorted((REPO / "taichi_gaussian_rasterizer_tpu_torch").rglob("*.py"))
  files += [REPO / "chip_smoke.py", REPO / "tests" / "torch_parallel_workers.py"]
  assert len(files) > 30
  banned = ("jax", "jaxlib", "taichi_gaussian_rasterizer_tpu")
  found = []
  for path in files:
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or ""] if node.level == 0 else []
      else:
        continue
      found += [f"{path.name}: {n}" for n in names
                if n.split(".")[0] in banned]
  assert not found, found
