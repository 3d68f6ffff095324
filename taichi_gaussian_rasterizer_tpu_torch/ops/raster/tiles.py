"""Tile <-> image layout helpers (port of
`taichi_gaussian_rasterizer_tpu.ops.raster.tiles`).

Tile-packed layout is (T, C, P): P = tile_size^2 pixels row-major within
the tile, tiles row-major over the padded image. The plain rasterizer
works in it; the CUDA kernel writes (H, W, C) directly.
`tile_pixel_centers` is left out: the plain version computes tile-local
centres itself.
"""

from typing import Tuple

import torch


def tiles_to_image(tiled: torch.Tensor, tile_shape: Tuple[int, int],
                   tile_size: int, image_size: Tuple[int, int]) -> torch.Tensor:
  """(T, C, P) tile-packed -> (H, W, C), cropped to image_size (w, h)."""
  th, tw = tile_shape
  t, c, p = tiled.shape
  if t != th * tw or p != tile_size * tile_size:
    raise ValueError(f"tiled shape {tuple(tiled.shape)} does not match "
                     f"{th}x{tw} tiles of {tile_size}^2 pixels")
  img = tiled.reshape(th, tw, c, tile_size, tile_size)
  img = img.permute(0, 3, 1, 4, 2)  # (th, ts, tw, ts, c)
  img = img.reshape(th * tile_size, tw * tile_size, c)
  w, h = image_size
  return img[:h, :w, :]


def image_to_tiles(image: torch.Tensor, tile_shape: Tuple[int, int],
                   tile_size: int) -> torch.Tensor:
  """(H, W, C) -> (T, C, P), zero-padding partial edge tiles."""
  th, tw = tile_shape
  h, w, c = image.shape
  ph, pw = th * tile_size, tw * tile_size
  if (ph, pw) != (h, w):
    image = torch.nn.functional.pad(image, (0, 0, 0, pw - w, 0, ph - h))
  img = image.reshape(th, tile_size, tw, tile_size, c)
  img = img.permute(0, 2, 4, 1, 3)  # (th, tw, c, ts, ts)
  return img.reshape(th * tw, c, tile_size * tile_size)
