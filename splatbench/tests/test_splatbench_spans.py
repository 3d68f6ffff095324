"""The readers of the port's spans (`splatbench/spans.py` and the metrics
that use it) on records written out by hand, on a CPU run, and on a port
without a tracing module."""

import sys

import pytest

from splatbench import harness, spans
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing


def rec(name, id, frame, parent=None, device_ms=1.0, host_ms=0.5, **counts):
  return dict(name="tgr." + name, id=id, parent=parent, frame=frame, start_ns=0,
              end_ns=int(host_ms * 1e6), host_ms=host_ms, device_ms=device_ms,
              counts=counts)


# two serve frames (roots 1 and 10), two training steps (frames 20 and 30,
# optimizer steps 25 and 35), two all-reduces (40 and 50)
RECORDS = [
    rec("render", 1, 1, device_ms=12.0),
    rec("project", 2, 1, 1, 3.0), rec("sh", 3, 1, 1, 2.0),
    rec("map", 4, 1, 1, 5.0, candidates=100, overlaps=40),
    rec("map.sync", 5, 1, 4, 0.1, host_ms=4.0),
    rec("raster.fwd", 6, 1, 1, 1.0),
    rec("render", 10, 10, device_ms=15.0),
    rec("project", 11, 10, 10, 4.0), rec("sh", 12, 10, 10, 2.0),
    rec("map", 13, 10, 10, 7.0, candidates=200, overlaps=150),
    rec("map.sync", 14, 10, 13, 0.1, host_ms=6.0),
    rec("raster.fwd", 15, 10, 10, 1.5),
    rec("raster.bwd", 21, 20, 20, 8.0), rec("reduce.sort", 22, 20, 21, 3.0),
    rec("project.bwd", 23, 20, 20, 30.0), rec("optim.step", 25, 25, None, 23.0),
    rec("raster.bwd", 31, 30, 30, 6.0), rec("reduce.sort", 32, 30, 31, 2.0),
    rec("project.bwd", 33, 30, 30, 34.0), rec("optim.step", 35, 35, None, 24.0),
    rec("dp.pack", 40, 40, None, 10.0), rec("dp.allreduce", 41, 40, 40, 6.0),
    rec("dp.pack", 50, 50, None, 12.0), rec("dp.allreduce", 51, 50, 50, 9.0),
]

EXPECTED = {
    "project_span_ms.serve": 5.5, "mapper_span_ms.serve": 6.0,
    "mapper_sync_ms.serve": 5.0, "mapper_accept_pct.serve": 57.5,
    "raster_fwd_span_ms.serve": 1.25, "project_bwd_span_ms.train": 32.0,
    "raster_bwd_span_ms.train": 7.0, "reduce_sort_ms.train": 2.5,
    "optim_span_ms.train": 23.5, "allreduce_span_ms.dp": 7.5,
    "dp_pack_ms.dp": 3.5,
}


def readers():
  bench = harness.load_benchmark()
  names = [m["name"] for m in bench["per_layer"]]
  assert set(EXPECTED) <= set(names)
  return {n: harness.load_metric(n) for n in EXPECTED}


def test_readers_take_medians_of_per_frame_sums(monkeypatch):
  monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in RECORDS])
  for name, reader in readers().items():
    assert reader.read(None) == pytest.approx(EXPECTED[name]), name


def test_readers_find_nothing_without_device_times(monkeypatch):
  host_only = [dict(r, device_ms=None) for r in RECORDS]
  monkeypatch.setattr(tracing, "records", lambda: host_only)
  assert all(reader.read(None) is None for reader in readers().values())
  monkeypatch.setattr(tracing, "records", lambda: [])
  assert all(reader.read(None) is None for reader in readers().values())


def test_readers_find_nothing_in_a_port_without_tracing(monkeypatch):
  monkeypatch.setitem(sys.modules, "taichi_gaussian_rasterizer_tpu_torch.utils.tracing",
                      None)
  monkeypatch.delattr("taichi_gaussian_rasterizer_tpu_torch.utils.tracing")
  assert spans.records() is None
  assert all(reader.read(None) is None for reader in readers().values())
