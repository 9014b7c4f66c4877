"""The frozen reference agrees with the port at tiny sizes on the CPU:
with the program in the reference's own precision every gap is zero or
nearly so, and the tiny runs come out correct."""

import copy

import pytest

from portbench.tests.helpers import tiny_run, tiny_values


def float32_program(ctx):
  ctx.config.CONFIG = copy.deepcopy(ctx.config.CONFIG)
  for key in ("policy", "train"):
    if "bf16" in ctx.config.CONFIG.get(key, {}):
      ctx.config.CONFIG[key]["bf16"] = False


@pytest.mark.parametrize("cell", ["tfpp.eval", "plant.eval", "tfpp.train",
                                  "plant.train"])
def test_program_in_float32_matches_the_reference(cell):
  values = tiny_values(cell, float32_program)
  assert values and max(values.values()) <= 1e-5, values


@pytest.mark.parametrize("cell", ["plant.eval", "plant.train"])
def test_tiny_runs_are_correct(cell):
  result = tiny_run(cell)
  assert result["correct"], result["checks"]
  assert result["failed"] == 0
  assert set(result) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
  assert list(result)[-1] == "checks"
  assert "setup_s" in result["metrics"]


def test_traced_tiny_run_keeps_its_shape():
  result = tiny_run("plant.eval", trace=True)
  assert result["correct"]
  assert {"busy_s", "window_s"} <= set(result["device"])
  assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
  assert list(result)[-1] == "checks"
