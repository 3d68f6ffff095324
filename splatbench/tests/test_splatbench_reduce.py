"""The gradient reduction's kernel share on records written out by hand,
with and without the `kernel_rows` count (a port before the one-pass
reduction carries `rows` and `chunks` only), and on the host alone."""

import pytest

from splatbench import harness
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing


def rec(name, id, frame, parent=None, device_ms=1.0, **counts):
  return dict(name="tgr." + name, id=id, parent=parent, frame=frame, start_ns=0,
              end_ns=1, host_ms=1e-6, device_ms=device_ms, counts=counts)


# three steps, each a frame with the sort's span (counts) and the span of
# its gather and sums (none); the middle step's rows were repacked
RECORDS = [
    rec("raster.bwd", 1, 1, device_ms=9.0),
    rec("reduce.sort", 2, 1, 1, rows=137, chunks=1, kernel_rows=137),
    rec("reduce.sort", 3, 1, 1),
    rec("raster.bwd", 4, 4, device_ms=9.0),
    rec("reduce.sort", 5, 4, 4, rows=137, chunks=1, kernel_rows=0),
    rec("reduce.sort", 6, 4, 4),
    rec("raster.bwd", 7, 7, device_ms=9.0),
    rec("reduce.sort", 8, 7, 7, rows=9, chunks=1, kernel_rows=9),
    rec("reduce.sort", 9, 7, 7),
    rec("optim.step", 10, 10, elements=1000, kernel_elements=1000),
]


def reader():
  entry, = [m for m in harness.load_benchmark()["per_layer"]
            if m["name"] == "reduce_kernel_pct.train"]
  assert entry["moves"] == "train_step_ms" and entry["unit"] == "%"
  assert entry["workloads"] == ["bicycle6m.train"]
  return harness.load_metric("reduce_kernel_pct.train")


def test_reader_takes_the_median_of_per_step_shares(monkeypatch):
  monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in RECORDS])
  assert reader().read(None) == pytest.approx(100.0)
  half = [dict(r) for r in RECORDS]
  half[1] = rec("reduce.sort", 2, 1, 1, rows=137, chunks=1, kernel_rows=0)
  monkeypatch.setattr(tracing, "records", lambda: half)
  assert reader().read(None) == pytest.approx(0.0)


def test_reader_finds_nothing_without_the_count_or_on_the_host(monkeypatch):
  # a port whose sort carries rows and chunks only, one span a block
  before = [rec("reduce.sort", 2, 1, 1, rows=137, chunks=3),
            rec("reduce.sort", 3, 1, 1), rec("reduce.sort", 4, 1, 1),
            rec("reduce.sort", 5, 1, 1)]
  monkeypatch.setattr(tracing, "records", lambda: before)
  assert reader().read(None) is None
  monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in RECORDS[-1:]])
  assert reader().read(None) is None
  host_only = [dict(r, device_ms=None) for r in RECORDS]
  monkeypatch.setattr(tracing, "records", lambda: host_only)
  assert reader().read(None) is None
