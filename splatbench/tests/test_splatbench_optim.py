"""The optimizer's readers on records written out by hand, and on records
of a port whose `tgr.optim.step` carries no counts (as before the kernel);
the optimizer's bound against a count by hand."""

import json
import types

import pytest

from splatbench import harness, optim_bounds
from taichi_gaussian_rasterizer_tpu_torch.utils import tracing


def rec(name, id, device_ms=1.0, **counts):
  return dict(name="tgr." + name, id=id, parent=None, frame=id, start_ns=0,
              end_ns=1, host_ms=1e-6, device_ms=device_ms, counts=counts)


# three steps, each its own frame; the middle one half on the kernel
RECORDS = [
    rec("optim.step", 1, 4.0, elements=1000, kernel_elements=1000),
    rec("optim.step", 2, 6.0, elements=1000, kernel_elements=500),
    rec("optim.step", 3, 5.0, elements=1000, kernel_elements=1000),
    rec("render", 4, 9.0),
]


def config(name):
  return json.loads((harness.ROOT / "splatbench" / "configs" / f"{name}.json").read_text())


def readers():
  names = [m["name"] for m in harness.load_benchmark()["per_layer"]]
  assert {"optim_kernel_pct.train", "optim_roofline.train"} <= set(names)
  return (harness.load_metric("optim_kernel_pct.train"),
          harness.load_metric("optim_roofline.train"))


def ctx(name="bicycle6m"):
  return types.SimpleNamespace(entry=types.SimpleNamespace(cfg=config(name)))


def test_readers_take_medians_of_per_step_values(monkeypatch):
  monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in RECORDS])
  pct, roofline = readers()
  assert pct.read(ctx()) == pytest.approx(100.0)
  bound = optim_bounds.step_bound(config("bicycle6m"))["ms"]
  assert roofline.read(ctx()) == pytest.approx(100.0 * bound / 5.0)


def test_readers_find_nothing_before_the_counts_or_on_the_host(monkeypatch):
  before = [dict(r, counts={}) for r in RECORDS]
  monkeypatch.setattr(tracing, "records", lambda: before)
  pct, roofline = readers()
  assert pct.read(ctx()) is None
  assert roofline.read(ctx()) is not None   # the span's time is there
  host_only = [dict(r, device_ms=None) for r in RECORDS]
  monkeypatch.setattr(tracing, "records", lambda: host_only)
  assert pct.read(ctx()) is None and roofline.read(ctx()) is None


@pytest.mark.parametrize("name,values,gb,ms", [
    ("bicycle6m", 59, 10.1504, 3.030),
    ("feat3dgs-bicycle6m", 187, 32.0128, 9.556)])
def test_bound_by_hand(name, values, gb, ms):
  """6.1M points: bicycle6m 3 + 3 + 4 + 1 + 3 * 16 = 59 values a point,
  6.1M * 59 * 28 B + 6.1M * 12 B = 10.150 GB, 3.030 ms at 3.35 TB/s; the
  Feature 3DGS configuration 128 more, 32.01 GB, 9.556 ms."""
  cfg = config(name)
  assert optim_bounds.values_per_point(cfg) == values
  b = optim_bounds.step_bound(cfg)
  assert b["bytes"] == 6_100_000 * values * 28 + 6_100_000 * 12
  assert b["bytes"] / 1e9 == pytest.approx(gb, abs=1e-4)
  assert b["ms"] == pytest.approx(ms, abs=5e-4)
  assert b["bound_by"] == "bytes"
