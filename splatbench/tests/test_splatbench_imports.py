"""The import check, and a run that finds no card."""

import os
import subprocess
import sys

from splatbench import harness

ROOT = harness.ROOT


def test_forbidden_names_are_compared_whole():
  assert harness.forbidden_loaded(["jax"]) == ["jax"]
  assert harness.forbidden_loaded(["jax.numpy", "jaxlib.xla_client"]) == [
      "jax.numpy", "jaxlib.xla_client"]
  assert harness.forbidden_loaded(["taichi_gaussian_rasterizer_tpu"]) == [
      "taichi_gaussian_rasterizer_tpu"]
  assert harness.forbidden_loaded(["taichi_gaussian_rasterizer_tpu.ops.mapper",
                                   "bench", "benchmarks.probe_r3", "flax"]) == [
      "bench", "benchmarks.probe_r3", "flax", "taichi_gaussian_rasterizer_tpu.ops.mapper"]
  assert harness.forbidden_loaded(["taichi_gaussian_rasterizer_tpu_torch",
                                   "taichi_gaussian_rasterizer_tpu_torch.ops",
                                   "jaxtyping", "benchmark", "torch"]) == []


def test_harness_and_port_load_nothing_forbidden():
  code = ("import sys; sys.path.insert(0, %r); "
          "import splatbench.runner, splatbench.readings, "
          "taichi_gaussian_rasterizer_tpu_torch, "
          "taichi_gaussian_rasterizer_tpu_torch.parallel, "
          "taichi_gaussian_rasterizer_tpu_torch.optim; "
          "from splatbench import harness; "
          "[harness.load_part(k, f.stem) for k in ('entries', 'recipes', 'losses', 'metrics') "
          "for f in (harness.HERE / k).glob('*.py') if f.stem != '__init__']; "
          "print(harness.forbidden_loaded(sys.modules))" % str(ROOT))
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == "[]"


def _run(cwd, env_extra):
  env = dict(os.environ, **env_extra)
  return subprocess.run(
      [sys.executable, "splatbench/run.py", "--workload", "bicycle6m.serve",
       "--seed", "3", "--seconds", "1", "--trace", "0"],
      capture_output=True, text=True, timeout=120, cwd=cwd, env=env)


def test_run_without_a_card_fails_and_prints_nothing():
  out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
  assert out.returncode != 0
  assert out.stdout == ""
  assert "CUDA device" in out.stderr


def test_run_without_the_port_fails_and_prints_nothing(tmp_path):
  import shutil
  shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
  shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  out = _run(tmp_path, {})
  assert out.returncode != 0
  assert out.stdout == ""
