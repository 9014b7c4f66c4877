"""Dataset storage: collected frames and PlanT datasets as npz files (port
of carla_garage_tpu/train/dataset_io.py).

Datasets normally stay on the device; these files carry them across
processes. The field names and dtypes are the JAX package's, so a file
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.train.plant_train import PlantDataset


def _save(obj, path: str):
  """Every tensor field of a dataclass as one compressed npz (a None field
  is left out, and loads as its default)."""
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  arrays = {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}
  np.savez_compressed(path, **arrays)


def _load(cls, path: str, device):
  """The fields of `cls` from an npz file. A field stored as a Python
  object (the JAX package saves an optional field that is None as a
  pickled None, which its own loader then refuses) is left to its default;
  nothing is unpickled."""
  dev = resolve_device(device)
  fields = {}
  with np.load(path, allow_pickle=False) as z:
    for k in z.files:
      try:
        fields[k] = torch.from_numpy(z[k]).to(dev)
      except ValueError:                  # an object array: not unpickled
        continue
  return cls(**fields)


def save_frames(frames: Frames, path: str):
  """Persist a Frames struct as one compressed npz shard."""
  _save(frames, path)


def load_frames(path: str, device="cuda") -> Frames:
  return _load(Frames, path, device)


def save_plant_dataset(ds: PlantDataset, path: str):
  _save(ds, path)


def load_plant_dataset(path: str, device="cuda") -> PlantDataset:
  return _load(PlantDataset, path, device)
