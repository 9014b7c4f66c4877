"""Random weights from the seed, made on the device in one draw.

The benchmark makes one state dict in the frozen reference's layout and
loads it into the program's model and into the reference's, so both
start from the same numbers. One uniform draw of every parameter at once
from a ``torch.Generator`` on the device, cut into views: a tensor of two
or more dimensions is scaled to variance 1/fan-in, a one-dimensional
``weight`` or ``scale`` (a norm's gain) is 1 + 0.1 u, every other
parameter 0.1 u.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch


LAYOUTS = Path(__file__).resolve().parent / "reference" / "layouts"


def spec_of(model: torch.nn.Module) -> list:
  """[(name, shape)] of a model's parameters, in its order (meta works)."""
  return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def layout(config: str) -> list:
  """The frozen reference model's [(name, shape)], written by
  ``python3 -m portbench.reference.flops``."""
  return [(n, tuple(s)) for n, s in
          json.loads((LAYOUTS / f"{config}.json").read_text())]


def make_state_dict(spec: list, seed: int, device) -> dict:
  total = sum(math.prod(s) for _, s in spec)
  g = torch.Generator(device=device).manual_seed(int(seed))
  u = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
  sd, off = {}, 0
  for name, shape in spec:
    n = math.prod(shape)
    x = u[off:off + n].view(shape)
    off += n
    if len(shape) >= 2:
      x.mul_(math.sqrt(3.0 / math.prod(shape[1:])))
    elif name.endswith(("weight", "scale")):
      x.mul_(0.1).add_(1.0)
    else:
      x.mul_(0.1)
    sd[name] = x
  return sd


def build(cls_fn, spec: list, seed: int, device) -> torch.nn.Module:
  """A model made by ``cls_fn()`` on `device`, loaded with the seed's
  weights in the layout `spec` (the frozen reference's). It is built on
  the device itself: its own initialization is a few launches, where the
  meta device's first use imports for seconds."""
  with torch.device(device):
    model = cls_fn()
  model.load_state_dict(make_state_dict(spec, seed, device))
  return model
