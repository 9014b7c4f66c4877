"""Load a flax parameter tree into the port's modules.

``load_flax_params(model, params)`` takes the tree as nested dicts of
numpy arrays (``{"params": {...}}`` or the inner dict) and copies every
leaf into the torch module of the same path. Layouts:
  conv kernel HWIO -> OIHW (grouped convs too: I is in/groups on both),
  3-D conv kernel THWIO -> OITHW;
  Dense kernel (in, out) -> (out, in);
  attention query/key/value kernel (in, heads, head_dim) -> (heads*head_dim,
  in), bias (heads, head_dim) -> (heads*head_dim,); out kernel
  (heads, head_dim, out) -> (out, heads*head_dim);
  LayerNorm scale -> weight; GroupNorm/AffineNorm scale and bias as named;
  the GRU cell's ``in`` -> ``in_``.
Every flax leaf must land on a torch parameter of the same size and every
torch parameter must be written, or it raises.

A reference PyTorch checkpoint (the ``model_*.pth`` state dicts of a
published ensemble) goes through ``convert.assemble`` instead, which renames
its keys onto the port's modules (``convert.torch_import``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_RENAME = {"in": "in_"}


def _convert(name: str, module: nn.Module, module_name: str,
             value: np.ndarray, target: torch.Tensor) -> torch.Tensor:
  v = torch.from_numpy(np.array(value, dtype=np.float32))
  if name == "kernel":
    if v.ndim == 5:                               # conv THWIO -> OITHW
      v = v.permute(4, 3, 0, 1, 2)
    elif v.ndim == 4:                             # conv HWIO -> OIHW
      v = v.permute(3, 2, 0, 1)
    elif v.ndim == 3 and module_name == "out":    # (heads, hd, out)
      v = v.reshape(-1, v.shape[-1]).T
    elif v.ndim == 3:                             # (in, heads, hd)
      v = v.reshape(v.shape[0], -1).T
    else:                                         # Dense (in, out)
      v = v.T
  v = v.reshape(target.shape) if name == "bias" else v
  if tuple(v.shape) != tuple(target.shape):
    raise ValueError(f"{module_name}/{name}: flax {tuple(value.shape)} -> "
                     f"{tuple(v.shape)} does not fit {tuple(target.shape)}")
  return v


def load_flax_params(model: nn.Module, params) -> nn.Module:
  """Copy a flax param tree into `model` in place; returns the model."""
  tree = params.get("params", params)
  written = set()

  def visit(module: nn.Module, node: dict, prefix: str, module_name: str):
    for key, value in node.items():
      if isinstance(value, dict):
        sub = getattr(module, _RENAME.get(key, key), None)
        if not isinstance(sub, nn.Module):
          raise KeyError(f"no torch module for flax path {prefix}{key}")
        visit(sub, value, f"{prefix}{key}/", key)
        continue
      tname = key
      if key == "kernel":
        tname = "weight"
      elif key == "scale" and isinstance(module, nn.LayerNorm):
        tname = "weight"
      target = getattr(module, tname, None)
      if not isinstance(target, torch.Tensor):
        raise KeyError(f"no torch parameter for flax path {prefix}{key}")
      with torch.no_grad():
        target.copy_(_convert(key, module, module_name, value, target))
      written.add(id(target))

  visit(model, tree, "", "")
  missing = [n for n, p in model.named_parameters() if id(p) not in written]
  if missing:
    raise KeyError(f"torch parameters not in the flax tree: {missing[:8]}")
  return model
