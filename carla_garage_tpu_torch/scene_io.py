"""Read and write a batch of scenes as one ``.npz`` file.

A file holds the four inputs of a rollout, ``(maps, lanes, scene, state)``,
flattened to arrays under '/'-joined field paths (``state/ego/pos``, ...).
The port has no scene builder yet, so its full-size runs start from a
committed file, ``data/synth_b16_v100_seed0.npz``: 16 episodes of the
JAX package's synthetic town with 100 vehicle slots, 100 NPCs and 2
walkers each (seed 0).
"""

from __future__ import annotations

import dataclasses
import typing
from pathlib import Path

import numpy as np
import torch

from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.maps.town_map import LaneGraph, MapStack
from carla_garage_tpu_torch.structs import Scene, SimState, tree_items

SYNTH_B16_V100 = Path(__file__).resolve().parent / "data" / \
    "synth_b16_v100_seed0.npz"

_ROOTS = {"maps": MapStack, "lanes": LaneGraph, "scene": Scene,
          "state": SimState}


def save_scene(path, maps: MapStack, lanes: LaneGraph, scene: Scene,
               state: SimState) -> None:
  """Write the tensors of the four structs, compressed."""
  arrays = {}
  for name, tree in zip(_ROOTS, (maps, lanes, scene, state)):
    for key, t in tree_items(tree, name):
      arrays[key] = t.detach().cpu().numpy()
  np.savez_compressed(path, **arrays)


def _build(cls, prefix: str, data: dict, device):
  hints = typing.get_type_hints(cls)
  kw = {}
  for f in dataclasses.fields(cls):
    key = f"{prefix}/{f.name}"
    hint = hints[f.name]
    if dataclasses.is_dataclass(hint):
      kw[f.name] = _build(hint, key, data, device)
    elif key in data:
      kw[f.name] = torch.tensor(data[key], device=device)
    elif f.default is dataclasses.MISSING:
      raise KeyError(f"scene file lacks {key}")
  return cls(**kw)


def load_scene(path=SYNTH_B16_V100, device="cuda"):
  """-> (maps, lanes, scene, state) on `device`; the state carries no
  agent (see agents/sensor_agent.sensor_agent_reset)."""
  dev = resolve_device(device)
  with np.load(path) as z:
    data = {k: z[k] for k in z.files}
  return tuple(_build(cls, name, data, dev) for name, cls in _ROOTS.items())
