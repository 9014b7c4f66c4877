"""The forward's floating-point operations, counted once against the
frozen reference and written into each configuration's file, and the
reference models' parameter layouts.

``torch.utils.flop_counter.FlopCounterMode`` on the meta device counts 2
operations a multiply-add of the convolutions and matmuls; nothing is
allocated. ``python3 -m portbench.reference.flops`` prints the count of
each configuration per sample and writes ``layouts/<config>.json``, the
[name, shape] of every parameter in order, from which the weights of
both sides are made (``portbench/weights.py``).
"""

from __future__ import annotations

import json

import torch


def forward_flops(model: torch.nn.Module, inputs) -> int:
  """Operations of ``model(*inputs)``; model and inputs on the meta
  device."""
  from torch.utils.flop_counter import FlopCounterMode
  model.requires_grad_(False)
  counter = FlopCounterMode(display=False)
  with counter:
    model(*inputs)
  return counter.get_total_flops()


def count(config_name: str, batch: int = 16) -> float:
  """Forward operations per sample of a configuration's reference model."""
  from portbench import harness
  mod = harness.load_config(config_name)
  with torch.device("meta"):
    model = mod.reference_model(mod.CONFIG["model"])
    inputs = mod.meta_inputs(mod.CONFIG["model"], batch)
  return forward_flops(model, inputs) / batch


def write_layout(config_name: str):
  from portbench import harness, weights
  mod = harness.load_config(config_name)
  with torch.device("meta"):
    spec = weights.spec_of(mod.reference_model(mod.CONFIG["model"]))
  weights.LAYOUTS.mkdir(exist_ok=True)
  (weights.LAYOUTS / f"{config_name}.json").write_text(
      json.dumps([[n, list(s)] for n, s in spec]) + "\n")


if __name__ == "__main__":
  from portbench import harness
  print(json.dumps({name: count(name) for name in harness.config_names()}))
  for name in harness.config_names():
    write_layout(name)
