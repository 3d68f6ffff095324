"""The readers of the SH kernel's count and backward span on records
written out by hand, and on records of a port whose `tgr.sh` carries no
counts and that has no `tgr.sh.bwd` (as before the kernel)."""

import pytest

from splatbench import harness
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing


def rec(name, id, frame, parent=None, device_ms=1.0, **counts):
  return dict(name="tgr." + name, id=id, parent=parent, frame=frame, start_ns=0,
              end_ns=1, host_ms=1e-6, device_ms=device_ms, counts=counts)


# two serve frames, one with a gathered subset in a second shading call, and
# two training steps
RECORDS = [
    rec("render", 1, 1), rec("sh", 2, 1, 1, points=100, kernel_points=100),
    rec("render", 10, 10), rec("sh", 11, 10, 10, points=100, kernel_points=100),
    rec("sh", 12, 10, 10, points=100, kernel_points=0),
    rec("sh.bwd", 21, 20, 2, 0.5), rec("sh.bwd", 31, 30, 11, 0.7),
]


def readers():
  names = [m["name"] for m in harness.load_benchmark()["per_layer"]]
  assert {"sh_kernel_pct.serve", "sh_bwd_span_ms.train"} <= set(names)
  return (harness.load_metric("sh_kernel_pct.serve"),
          harness.load_metric("sh_bwd_span_ms.train"))


def test_readers_take_medians_of_per_frame_sums(monkeypatch):
  monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in RECORDS])
  pct, bwd = readers()
  assert pct.read(None) == pytest.approx(75.0)
  assert bwd.read(None) == pytest.approx(0.6)


def test_readers_find_nothing_before_the_kernel(monkeypatch):
  before = [dict(r, counts={}) for r in RECORDS if r["name"] != "tgr.sh.bwd"]
  monkeypatch.setattr(tracing, "records", lambda: before)
  assert all(reader.read(None) is None for reader in readers())
  host_only = [dict(r, device_ms=None) for r in RECORDS]
  monkeypatch.setattr(tracing, "records", lambda: host_only)
  assert all(reader.read(None) is None for reader in readers())
