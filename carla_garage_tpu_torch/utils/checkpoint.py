"""Checkpoint save and restore (port of carla_garage_tpu/utils/checkpoint.py).

A checkpoint is a directory: ``state.pt`` holds the model's state dict as
CPU tensors (and the optimizer's state, when given), ``meta.json`` the
JSON sidecar the JAX package writes beside its orbax state, with the same
keys (``model``, ``config``, ``step``, ``eval``, ``best_eval``,
``dagger_round``, ``samples``, ``recipe``: whichever the writer has).
``config_from_meta`` rebuilds the model config from the sidecar, so a
model can be built before its weights are read.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from carla_garage_tpu_torch.models.plant import PlanTConfig
from carla_garage_tpu_torch.models.transfuser import (
    VIDEO_SWIN, TransfuserConfig, VideoTransfuserConfig)
from carla_garage_tpu_torch.models.vla import SimLingoConfig

CONFIGS = {"transfuser": TransfuserConfig, "plant": PlanTConfig,
           "simlingo": SimLingoConfig}


def cpu_state(model_or_state_dict) -> dict:
  """The state dict as detached CPU copies: a snapshot that later training
  of the live parameters does not change."""
  sd = model_or_state_dict.state_dict() \
      if isinstance(model_or_state_dict, torch.nn.Module) \
      else model_or_state_dict
  return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def save_checkpoint(path: str, model_or_state_dict, meta: dict | None = None,
                    optimizer: torch.optim.Optimizer | None = None):
  """Write `path`/state.pt (the state dict on the CPU, and the optimizer's
  state dict when given) and, with meta, `path`/meta.json. The state file
  is written to a temporary name and renamed, so a reader never sees a
  torn file."""
  os.makedirs(path, exist_ok=True)
  payload = {"model": cpu_state(model_or_state_dict)}
  if optimizer is not None:
    payload["optimizer"] = optimizer.state_dict()
  tmp = os.path.join(path, "state.pt.tmp")
  torch.save(payload, tmp)
  os.replace(tmp, os.path.join(path, "state.pt"))
  if meta is not None:
    with open(os.path.join(path, "meta.json"), "w") as f:
      json.dump(meta, f, indent=1)


def load_checkpoint(path: str, model: torch.nn.Module | None = None,
                    meta_only: bool = False,
                    optimizer: torch.optim.Optimizer | None = None):
  """-> (state dict on the CPU, meta or None). With `model`, the state is
  also loaded into it (strictly: every key must match); with `optimizer`,
  the saved optimizer state into it. meta_only=True reads only meta.json
  and returns (None, meta)."""
  meta = None
  mp = os.path.join(path, "meta.json")
  if os.path.exists(mp):
    with open(mp) as f:
      meta = json.load(f)
  if meta_only:
    return None, meta
  payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       weights_only=True)
  if model is not None:
    model.load_state_dict(payload["model"])
  if optimizer is not None:
    if "optimizer" not in payload:
      raise KeyError(f"{path}/state.pt holds no optimizer state")
    optimizer.load_state_dict(payload["optimizer"])
  return payload["model"], meta


def _tuples(v):
  return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config_from_meta(meta: dict):
  """The TransfuserConfig, PlanTConfig or SimLingoConfig a checkpoint was
  saved with, from its meta.json: ``meta["model"]`` names the class and
  ``meta["config"]`` holds its fields (missing ones take their defaults);
  a TransfuserConfig with ``lidar_arch="video_swin_t"`` is a
  VideoTransfuserConfig. JSON lists become tuples again, so the result
  equals and hashes like the saved config. Raises on an unknown model or
  field."""
  cls = CONFIGS.get(meta.get("model"))
  if cls is None:
    raise ValueError(f"meta.json model {meta.get('model')!r}: expected one "
                     f"of {sorted(CONFIGS)}")
  if cls is TransfuserConfig and \
      meta["config"].get("lidar_arch") == VIDEO_SWIN:
    cls = VideoTransfuserConfig
  names = {f.name for f in dataclasses.fields(cls)}
  unknown = set(meta["config"]) - names
  if unknown:
    raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
  return cls(**{k: _tuples(v) for k, v in meta["config"].items()})
