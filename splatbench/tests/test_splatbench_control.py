"""The control, the reference computed in TF32 put in the program's place,
comes out not correct against the reference in float32, by the cell's own
limits; at a small size on the CPU (the chip runs it at the cells' own
sizes through `splatbench/readings.py --control`)."""

import pytest

from splatbench import harness, runner
from splatbench.tests import small


@pytest.mark.parametrize("name,field", [("bicycle6m.serve", False),
                                        ("bicycle6m.train", True),
                                        ("bicycle6m.train", False)])
def test_control_fails_the_limits(name, field):
  cell = small.small_cell(name, field=field)
  dev = runner.Device("cpu")
  entry = runner.make_entry(cell, 2**41 + 5, dev)
  entry.setup()
  entry.window(0.3, False)
  entry.free()
  ref = entry.reference_readings()
  ctrl = entry.reference_readings(tf32=True)
  checks = harness.judge(entry.compare(ctrl, ref), cell.limits)
  assert not harness.all_within(checks), checks
  sound = harness.judge(entry.compare(entry.reference_readings(), ref), cell.limits)
  assert harness.all_within(sound), sound
