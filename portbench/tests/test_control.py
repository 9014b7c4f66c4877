"""The control, the reference one precision below the configuration's in
the program's place, comes out not correct: at the tests' sizes on the
CPU for every cell, and at a cell's own size on the card (skipped here).
"""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.helpers import TINY, context


def control_values(cell: str) -> dict:
  ctx = context(cell)
  harness.point_caches()
  drv = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
  drv.setup()
  drv.window(0.3)
  drv.release()
  return drv.check(control=True)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
  values = control_values(cell)
  limits = harness.load_limits(cell)
  control = [{"name": k, "value": values[f"control_{k}"], "limit": v}
             for k, v in limits.items()]
  program = [{"name": k, "value": values[k], "limit": v}
             for k, v in limits.items()]
  assert not harness.judge(control)[0], values
  # the program's own numbers are below the control's
  assert all(p["value"] <= c["value"] for p, c in zip(program, control) if
             c["value"] > c["limit"])


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card: the control at a cell's own size")
  return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("cell", ["plant.eval", "tfpp.eval"])
def test_control_at_full_size(card, cell):
  proc = subprocess.run(
      [sys.executable, "-m", "portbench.calibrate", "--workload", cell,
       "--seeds", "2147483999", "--control-seeds", "2147483999",
       "--seconds", "3"], cwd=harness.ROOT, capture_output=True, text=True,
      timeout=900)
  assert proc.returncode == 0, proc.stderr[-2000:]
  values = json.loads(proc.stdout.strip().splitlines()[-1])["values"]
  limits = harness.load_limits(cell)
  assert not harness.judge([{"name": k, "value": values[f"control_{k}"],
                             "limit": v} for k, v in limits.items()])[0]
  assert harness.judge([{"name": k, "value": values[k], "limit": v}
                        for k, v in limits.items()])[0]
