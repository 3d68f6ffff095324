"""The frozen bound arithmetic against the port's `ops/raster/bounds.py`,
on small frames."""

import pytest
import torch

from splatbench import bounds, reference, scenes
from taichi_gaussian_rasterizer_tpu_torch import RasterConfig
from taichi_gaussian_rasterizer_tpu_torch.ops.raster import bounds as port_bounds
from taichi_gaussian_rasterizer_tpu_torch.ops.mapper import TileMapping, point_offsets


def _frame(recipe, seed):
  cfg = {"scene": {"recipe": recipe, "points": 2500}, "image_size": [110, 75],
         "features": {"kind": "raw", "channels": 4}, "render_depth": False,
         "geometry_seed": seed}
  camera, g = scenes.make_scene(cfg, seed, "cpu")
  r = reference.render(g, camera, cfg)
  m = r["mapping"]
  otp = m["otp"].to(torch.int32)
  n = r["points"].shape[0]
  mapping = TileMapping(
      overlap_to_point=otp, overlap_to_tile=torch.zeros_like(otp),
      tile_ranges=m["ranges"].to(torch.int32), tile_shape=m["tile_shape"],
      total_overlaps=torch.tensor(otp.shape[0]), overflow=m["overflow"],
      point_sentinel=n, point_offsets=point_offsets(otp, n))
  return r, mapping


@pytest.mark.parametrize("recipe,seed", [("random", 5), ("trained_like", 6),
                                         ("trained_like", 2**33 + 1)])
def test_active_pairs_equal_the_ports_count(recipe, seed):
  r, mapping = _frame(recipe, seed)
  work = port_bounds.raster_work(r["points"].detach(), mapping, RasterConfig(),
                                 r["size"])
  assert r["active"] == work["active"] > 0


def test_bound_functions_equal_the_ports():
  work = {"active": 123456789}
  for args in [(1000, 3, 5000, 96, (110, 75), False),
               (6_100_000, 3, 30_000_000, 11008, (2048, 1361), False),
               (1_000_000, 34, 2_700_000, 12288, (2048, 1536), False)]:
    assert bounds.forward_bound(work, *args) == port_bounds.forward_bound(work, *args)
    for flags in [(False, False), (True, True)]:
      assert bounds.backward_bound(work, *args, *flags) == \
          port_bounds.backward_bound(work, *args, *flags)
    n, f, k = args[0], args[1], args[2]
    assert bounds.segment_sum_bound(bounds.backward_rows(f), k, n) == \
        port_bounds.segment_sum_bound(6 + f, k, n)
  assert (bounds.PEAK_FP32_FLOPS, bounds.PEAK_BYTES_PER_S) == (
      port_bounds.PEAK_FP32_FLOPS, port_bounds.PEAK_BYTES_PER_S)
