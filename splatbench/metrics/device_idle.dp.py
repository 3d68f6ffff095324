"""`device_idle.train`'s reading, in the four-card cell, where it moves
`world_step_ms` (rank 0's frame and profile): the same reader, found by
its own name."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("device_idle.train.py")))["read"]
