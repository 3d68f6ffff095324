#!/usr/bin/env python3
"""Time the SH kernels (`csrc/sh.cu`) on one NVIDIA GPU, by default at the
benchmark's shape (6.1M points, 3 channels, degree 3, float32), after
holding them against the plain version (`chip_smoke.sh_kernels`): the
forward without and with the clamp's gate, the backward (d_sh), each
beside its bound in bytes, and the plain version's forward and backward
with its einsum and the einsum's backward. Coefficients uniform in
[-0.5, 0.5], positions normal with deviation 4, all seeded. Prints one
JSON line (and writes it to --out).

    python3 tools/time_sh_kernels.py [--n N] [--channels C] [--degree D]
                                     [--out FILE]
"""

import argparse
import json
import pathlib
import sys

import torch


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--n", type=int, default=6_100_000)
  parser.add_argument("--channels", type=int, default=3)
  parser.add_argument("--degree", type=int, default=3)
  parser.add_argument("--out", type=pathlib.Path)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("time_sh_kernels: no CUDA device", file=sys.stderr)
    return 1
  sys.path[:0] = [str(pathlib.Path(__file__).resolve().parents[1])]
  import chip_smoke
  from taichi_gaussian_rasterizer_tpu_torch.ops import sh as sh_ops

  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(0)
  k = (args.degree + 1) ** 2
  feats = torch.rand((args.n, args.channels, k), generator=gen, device=dev) - 0.5
  pos = torch.randn((args.n, 3), generator=gen, device=dev) * 4
  cam = torch.randn(3, generator=gen, device=dev)
  result = dict(card=chip_smoke.card_line(), n=args.n, channels=args.channels,
                degree=args.degree,
                **chip_smoke.sh_kernels(sh_ops, feats, pos, cam))
  line = json.dumps(result)
  print(line)
  if args.out:
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
