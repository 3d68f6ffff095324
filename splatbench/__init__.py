"""The benchmark of the PyTorch/CUDA port (`taichi_gaussian_rasterizer_tpu_torch`);
`python3 splatbench/run.py --help`. Imports nothing of JAX or of the JAX package."""
