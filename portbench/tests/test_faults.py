"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (``portbench.faults``): a step that returns
its state unchanged, half of the batch left out with the mean over the
rest, and an answer altered where it is produced. No cell spans chips, so
no exchange between chips can be left out."""

import pytest

from portbench import faults, harness
from portbench.tests.helpers import tiny_values

CASES = [("plant.eval", "eval_state_unchanged"),
         ("plant.eval", "eval_half_batch"),
         ("plant.eval", "eval_control_altered"),
         ("tfpp.eval", "eval_sensor_altered"),
         ("plant.train", "train_state_unchanged"),
         ("plant.train", "train_half_batch"),
         ("plant.train", "train_loss_altered"),
         ("tfpp.train", "train_state_unchanged"),
         ("tfpp.train", "train_half_batch")]


def verdict(cell, values):
  limits = harness.load_limits(cell)
  return harness.judge([{"name": k, "value": values[k], "limit": v}
                        for k, v in limits.items()])[0]


def test_sound_tiny_runs_pass():
  for cell in ("plant.eval", "plant.train"):
    assert verdict(cell, tiny_values(cell))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
  undo = []
  values = tiny_values(
      cell, lambda ctx: undo.append(faults.FAULTS[fault](ctx)))
  undo[0]()
  assert not verdict(cell, values), values
