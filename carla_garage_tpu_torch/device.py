"""Device choice and the few numeric helpers every layer of the port shares."""

from __future__ import annotations

import numpy as np
import torch

_I32_MAX = torch.iinfo(torch.int32).max


def resolve_device(device="cuda") -> torch.device:
  """The device an entry point builds its tensors on.

  The default is the card. The CPU is used only when the caller names it;
  asking for CUDA on a host without a card raises instead of quietly
  running on the CPU."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"device {device!r} requested but torch.cuda.is_available() is "
        "False; pass device='cpu' to run on the CPU")
  return dev


def to_int32(x: torch.Tensor) -> torch.Tensor:
  """float -> int32 as XLA and CUDA convert: truncate toward zero, saturate
  at the int32 range, NaN -> 0.

  A plain ``.to(torch.int32)`` on the CPU turns NaN and out-of-range values
  into INT_MIN, which clips to the other edge of a raster than the JAX
  package's conversion does (camera rays above the horizon carry infinite
  ground points)."""
  big = x >= 2.0 ** 31
  y = torch.where(torch.isnan(x) | big, torch.zeros_like(x), x)
  y = y.clamp(min=-(2.0 ** 31)).to(torch.int32)
  return torch.where(big, torch.full_like(y, _I32_MAX), y)


_CONSTS: dict = {}


def const(values, device, dtype=torch.float32) -> torch.Tensor:
  """A small constant tensor on `device`, made on first use and reused.

  A tick builds its constants (palettes, offsets, noise matrices) through
  this, so it copies nothing from the host: a copy from pageable host
  memory waits for the device's queue to drain. Callers must not write
  into the returned tensor."""
  arr = np.asarray(values)
  key = (arr.tobytes(), arr.shape, arr.dtype.str, str(device), dtype)
  t = _CONSTS.get(key)
  if t is None:
    t = _CONSTS[key] = torch.as_tensor(arr, device=device).to(dtype)
  return t
