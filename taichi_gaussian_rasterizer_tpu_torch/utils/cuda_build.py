"""Build the package's CUDA sources at first use and bind them with ctypes.

Each source under `csrc/` exposes a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library under the checkout's
`build/kernels/`, named by a hash of the source, every header under
`csrc/` and the flags, so an unchanged source is built once and a change
to it or to a header it may include is rebuilt. No PyTorch header is
included: a build takes seconds, not minutes.

This module owns the boundary between Python and the C entry points: a
`CudaKernel` declares its entry point's arguments as typed slots, the
ctypes argument types come from them, and `launch` checks every argument
against its slot before anything is built, so a kernel's wrapper keeps
only the shapes of its own format.

Nothing is built or loaded when this module is imported; a build that
fails (no `nvcc`, a compile error) raises, and nothing falls back.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

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
  # one name a process and thread: two entry points of one source may build
  # it at once
  tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
  proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
  os.replace(tmp, out)   # atomic: a concurrent process never loads a partial file
  return out, proc.stdout + proc.stderr


# A signature lists an entry point's arguments as "<type> <name>, ...": a
# scalar's C type (int, long long, float, double), or a tensor's dtype (f32,
# i32, i64, u8, or real: the kernel's float type, float32 or float64, one for
# every slot so marked) followed by "@<bytes>" where the entry point needs
# that alignment and "?" where it takes NULL.
_CTYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float, "double": ctypes.c_double}
_DTYPES = {"f32": torch.float32, "i32": torch.int32, "i64": torch.int64,
           "u8": torch.uint8}
_ARG = re.compile(r"\s*(?:(int|long long|float|double)"
                  r"|(f32|i32|i64|u8|real)(?:@(\d+))?(\?)?)\s+(\w+)\s*")


class Slot(NamedTuple):
  """One argument: a scalar of C type `ctype`, or, with `ctype` c_void_p,
  a tensor of `dtype` (None: the kernel's float type), `align`-byte
  aligned, None (NULL) only where `optional`."""
  name: str
  ctype: type
  dtype: Optional[torch.dtype]
  optional: bool
  align: int


def parse_signature(text: str) -> Tuple[Slot, ...]:
  """The slots of a signature, in order."""
  slots = []
  for arg in text.split(","):
    m = _ARG.fullmatch(arg)
    if m is None:
      raise ValueError(f"not an argument of a signature: {arg.strip()!r}")
    scalar, dtype, align, optional, name = m.groups()
    slots.append(Slot(name, _CTYPES.get(scalar, ctypes.c_void_p),
                      _DTYPES.get(dtype), bool(optional), int(align or 1)))
  return tuple(slots)


class CudaKernel:
  """One C entry point of a CUDA source, built and loaded at first use.

  `signature` lists the entry point's arguments but the trailing
  `void* stream`. The entry point returns the `cudaError_t` of its
  launch; `launch` raises on a non-zero status and otherwise adds one to
  `launch_count` (and, under `runtime.debug_mode`, synchronises, which
  raises on a fault during the run).
  The source must also export `const char* tgr_error_string(int)`.
  """

  def __init__(self, source: str, symbol: str, signature: str):
    self.source = source
    self.symbol = symbol
    self.signature = signature
    self.slots = parse_signature(signature)
    self.launch_count = 0
    self.build_log = ""
    self._fn = None
    self._error_string = None

  def load(self):
    if self._fn is None:
      path, self.build_log = build(self.source)
      lib = ctypes.CDLL(str(path))
      fn = getattr(lib, self.symbol)
      fn.argtypes = [slot.ctype for slot in self.slots] + [ctypes.c_void_p]
      fn.restype = ctypes.c_int
      err = lib.tgr_error_string
      err.argtypes = [ctypes.c_int]
      err.restype = ctypes.c_char_p
      self._fn, self._error_string = fn, err
    return self._fn

  def launch(self, *args) -> None:
    """Launch with `args`, one a slot: each tensor passed as its pointer,
    then the current stream of the tensors' device. Before anything is
    built or loaded, a dtype a slot does not take, or None in a slot that
    is not optional, raises TypeError; then a strided or misaligned
    tensor, or one not on the launch's one CUDA device, raises
    ValueError."""
    if len(args) != len(self.slots):
      raise TypeError(f"{self.symbol} takes {len(self.slots)} arguments, "
                      f"got {len(args)}")
    real, tensors = None, []
    for i, (slot, arg) in enumerate(zip(self.slots, args)):
      where = f"{self.symbol}: {slot.name}"
      if slot.ctype is not ctypes.c_void_p:
        value = slot.ctype(arg).value   # a value of the wrong kind raises TypeError
        if isinstance(arg, int) and value != arg:
          raise ValueError(f"{where} = {arg} does not fit a C {slot.ctype.__name__}")
      elif arg is None:
        if not slot.optional:
          raise TypeError(f"{where} is required, got None")
      else:
        if slot.dtype is None:
          real = real or arg.dtype
          if real not in (torch.float32, torch.float64):
            raise TypeError(f"{where} takes float32 or float64, got {arg.dtype}")
        if arg.dtype != (slot.dtype or real):
          raise TypeError(f"{where} takes {slot.dtype or real}, got {arg.dtype}")
        tensors.append((i, where, slot.align, arg))
    c_args, device = list(args), tensors[0][3].device if tensors else None
    for i, where, align, t in tensors:
      c_args[i] = t.data_ptr()
      if not t.is_contiguous():
        raise ValueError(f"{where} must be contiguous")
      if c_args[i] % align:
        raise ValueError(f"{where} must be {align}-byte aligned")
      if not t.is_cuda or t.device != device:
        raise ValueError(f"{where} is on {t.device}: {self.symbol} takes "
                         f"CUDA tensors on one device")
    status = self.load()(*c_args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
      raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {status} "
                         f"({self._error_string(status).decode()})")
    self.launch_count += 1
    if SYNC_AFTER_LAUNCH:
      torch.cuda.synchronize()


def aligned(t: torch.Tensor, align: int) -> torch.Tensor:
  """t made contiguous, and copied where its data is not `align`-byte
  aligned."""
  t = t.contiguous()
  return t.clone() if t.data_ptr() % align else t


def load_all(kernels: Sequence[CudaKernel]) -> None:
  """Build and load several kernels at once, one nvcc process each."""
  with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
    for future in [pool.submit(k.load) for k in kernels]:
      future.result()
