"""Build the package's CUDA sources at first use and bind them with ctypes.

Each source under `csrc/` exposes a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library under the checkout's
`build/kernels/`, named by a hash of the source, every header under
`csrc/` and the flags, so an unchanged source is built once and a change
to it or to a header it may include is rebuilt. No PyTorch header is
included: a build takes seconds, not minutes.

Nothing is built or loaded when this module is imported; a build that
fails (no `nvcc`, a compile error) raises, and nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# set by runtime.debug_mode: synchronise after each launch, so that a
# fault inside a kernel raises at its launch
SYNC_AFTER_LAUNCH = False


def find_nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  candidates = [shutil.which("nvcc"),
                os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
                "/usr/local/cuda/bin/nvcc"]
  for cand in candidates:
    if cand and os.access(cand, os.X_OK):
      return cand
  raise RuntimeError(
      "nvcc not found: the CUDA kernels are built from source at first use; "
      "put the CUDA toolkit's nvcc on PATH or set CUDA_HOME")


def source_digest(source: str, csrc_dir: Path = CSRC_DIR) -> str:
  """Hash of csrc/<source>, of every csrc/*.cuh header (name and bytes)
  and of the flags: the key of the built library."""
  h = hashlib.sha256((csrc_dir / source).read_bytes())
  for header in sorted(csrc_dir.glob("*.cuh")):
    h.update(header.name.encode() + b"\0" + header.read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  return h.hexdigest()[:16]


def build(source: str) -> tuple:
  """Compile csrc/<source> into build/kernels/; returns (library path,
  compiler log). The log is empty when the library was already built."""
  src = CSRC_DIR / source
  out = BUILD_DIR / f"{src.stem}_{source_digest(source)}.so"
  if out.exists():
    return out, ""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
  proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
  os.replace(tmp, out)   # atomic: a concurrent process never loads a partial file
  return out, proc.stdout + proc.stderr


class CudaKernel:
  """One C entry point of a CUDA source, built and loaded at first use.

  The entry point returns the `cudaError_t` of its launch; `launch`
  raises on a non-zero status and otherwise adds one to `launch_count`
  (and, under `runtime.debug_mode`, synchronises, which raises on a fault
  during the run).
  The source must also export `const char* tgr_error_string(int)`.
  """

  def __init__(self, source: str, symbol: str, argtypes: Sequence):
    self.source = source
    self.symbol = symbol
    self.argtypes = list(argtypes)
    self.launch_count = 0
    self.build_log = ""
    self._fn = None
    self._error_string = None

  def load(self):
    if self._fn is None:
      path, self.build_log = build(self.source)
      lib = ctypes.CDLL(str(path))
      fn = getattr(lib, self.symbol)
      fn.argtypes = self.argtypes
      fn.restype = ctypes.c_int
      err = lib.tgr_error_string
      err.argtypes = [ctypes.c_int]
      err.restype = ctypes.c_char_p
      self._fn, self._error_string = fn, err
    return self._fn

  def launch(self, *args) -> None:
    status = self.load()(*args)
    if status != 0:
      raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {status} "
                         f"({self._error_string(status).decode()})")
    self.launch_count += 1
    if SYNC_AFTER_LAUNCH:
      import torch
      torch.cuda.synchronize()


def load_all(kernels: Sequence[CudaKernel]) -> None:
  """Build and load several kernels at once, one nvcc process each."""
  with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
    for future in [pool.submit(k.load) for k in kernels]:
      future.result()
