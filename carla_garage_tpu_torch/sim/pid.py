"""PID controllers over explicit window state (port of
carla_garage_tpu/sim/pid.py): a length-n error window pre-filled with
zeros, integral = mean(window), derivative = window[-1] - window[-2]."""

from __future__ import annotations

import dataclasses

import torch

from carla_garage_tpu_torch.structs import PIDState


@dataclasses.dataclass(frozen=True)
class PIDParams:
  k_p: float
  k_i: float
  k_d: float
  n: int = 20


def pid_step(state: PIDState, error: torch.Tensor, p: PIDParams):
  """Append error, return (new_state, output). error [...] matches window[...,n]."""
  window = torch.cat([state.window[..., 1:], error[..., None]], dim=-1)
  integral = torch.mean(window, dim=-1)
  derivative = window[..., -1] - window[..., -2]
  out = p.k_p * error + p.k_i * integral + p.k_d * derivative
  return PIDState(window=window), out
