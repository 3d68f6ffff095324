"""A run whose timed path is broken underneath comes out not correct,
once for each fault its cell can have; the same run unbroken comes out
correct. Small sizes on the CPU: the harness's look for a card is skipped
and the rest of a run is driven, judged by the cell's own limits."""

import pytest

import taichi_gaussian_rasterizer_tpu_torch as tgr
from taichi_gaussian_rasterizer_tpu_torch.models import renderer
from taichi_gaussian_rasterizer_tpu_torch.optim import ParameterClass
from splatbench.tests import faults, small


@pytest.fixture
def restore(monkeypatch):
  """Put the port back as it was after a fault planted in this process."""
  monkeypatch.setattr(tgr, "render_gaussians", tgr.render_gaussians)
  monkeypatch.setattr(renderer, "rasterize_with_tiles", renderer.rasterize_with_tiles)
  monkeypatch.setattr(ParameterClass, "step", ParameterClass.step)
  monkeypatch.setattr(ParameterClass, "create", ParameterClass.create)


CASES = [
    ("bicycle6m.serve", False, None),
    ("bicycle6m.serve", False, faults.answer_altered),
    ("bicycle6m.train", True, None),
    ("bicycle6m.train", True, faults.state_unchanged),
    ("bicycle6m.train", True, faults.half_batch),
    ("bicycle6m.train", True, faults.lr_off),
    ("bicycle6m.train", False, None),
    ("bicycle6m.train", False, faults.state_unchanged),
    ("bicycle6m.train", False, faults.half_batch),
    ("bicycle6m.train", False, faults.lr_off),
    ("bicycle6m.dp4-train", False, None),
    ("bicycle6m.dp4-train", False, faults.state_unchanged),
    ("bicycle6m.dp4-train", False, faults.half_batch),
    ("bicycle6m.dp4-train", False, faults.exchange_left_out),
    ("bicycle6m.dp4-train", False, faults.lr_off),
]


@pytest.mark.parametrize(
    "name,field,fault", CASES,
    ids=[f"{n}{'-field' if fd else ''}-{f.__name__ if f else 'sound'}"
         for n, fd, f in CASES])
def test_fault_is_caught(restore, name, field, fault):
  correct, numbers, _ = small.run(small.small_cell(name, field=field), hook=fault)
  assert correct == (fault is None), numbers
