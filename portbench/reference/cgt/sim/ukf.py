"""Unscented Kalman filter over (x, y, yaw, v) (port of
carla_garage_tpu/sim/ukf.py): Merwe scaled sigma points, bicycle-model
process function, identity measurement, circular yaw means/residuals, and
the JAX package's noise matrices.

The factorisations use ``cholesky_ex`` / ``solve_ex``, which do not check
for failure on the host, so a tick has no host sync here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.cgt.config import SimConfig
from portbench.reference.cgt.device import const, resolve_device
from portbench.reference.cgt.sim.dynamics import bicycle_step
from portbench.reference.cgt.sim.geometry import normalize_angle
from portbench.reference.cgt.structs import Struct

N = 4
# alpha=1 (unit-spread sigma points, lambda=0), as the JAX package chose
# for fp32 stability
ALPHA, BETA, KAPPA = 1.0, 2.0, 0.0
LAMBDA = ALPHA * ALPHA * (N + KAPPA) - N

P0_DIAG = (0.5, 0.5, 1e-6, 1e-6)
R_DIAG = (0.5, 0.5, 1e-6, 1e-6)
Q_DIAG = (1e-4, 1e-4, 1e-3, 1e-3)


@dataclasses.dataclass
class UKFState(Struct):
  x: torch.Tensor            # [B,4] (px, py, yaw, v)
  P: torch.Tensor            # [B,4,4]
  initialized: torch.Tensor  # [B] bool


def _diag(vals, device) -> torch.Tensor:
  return const(np.diag(vals), device)


def ukf_reset(B: int, device="cuda") -> UKFState:
  dev = resolve_device(device)
  return UKFState(x=torch.zeros((B, N), device=dev),
                  P=_diag(P0_DIAG, dev).expand(B, N, N).clone(),
                  initialized=torch.zeros((B,), dtype=torch.bool, device=dev))


def _weights(device):
  wm = np.full(2 * N + 1, 1.0 / (2 * (N + LAMBDA)), np.float32)
  wc = wm.copy()
  wm[0] = LAMBDA / (N + LAMBDA)
  wc[0] = LAMBDA / (N + LAMBDA) + (1 - ALPHA ** 2 + BETA)
  return const(wm, device), const(wc, device)


def _sigma_points(x, P):
  """x [B,4], P [B,4,4] -> [B,2N+1,4]."""
  eye = torch.eye(N, device=x.device)
  A, _ = torch.linalg.cholesky_ex((N + LAMBDA) * (P + 1e-6 * eye))
  At = A.transpose(-1, -2)
  return torch.cat([x[:, None], x[:, None] + At, x[:, None] - At], dim=1)


def _angle_mean(pts, wm):
  """Weighted mean with circular yaw."""
  m = torch.einsum("s,bsd->bd", wm, pts)
  sin_m = torch.einsum("s,bs->b", wm, torch.sin(pts[..., 2]))
  cos_m = torch.einsum("s,bs->b", wm, torch.cos(pts[..., 2]))
  return torch.cat([m[:, :2], torch.atan2(sin_m, cos_m)[:, None], m[:, 3:]],
                   -1)


def _residual(a, b):
  y = a - b
  return torch.cat([y[..., :2], normalize_angle(y[..., 2:3]), y[..., 3:]],
                   -1)


def ukf_predict(state: UKFState, steer, throttle, brake, cfg: SimConfig,
                dt: float = 0.05) -> UKFState:
  """Process update with the applied control."""
  wm, wc = _weights(state.x.device)
  pts = _sigma_points(state.x, state.P)                       # [B,S,4]
  pos, yaw, spd = bicycle_step(
      pts[..., :2], pts[..., 2], pts[..., 3],
      steer[:, None], throttle[:, None], brake[:, None], cfg, dt=dt)
  fpts = torch.cat([pos, yaw[..., None], spd[..., None]], -1)
  xm = _angle_mean(fpts, wm)
  d = _residual(fpts, xm[:, None])
  P = torch.einsum("s,bsi,bsj->bij", wc, d, d) + _diag(Q_DIAG, d.device)
  return state.replace(x=xm, P=P)


def ukf_update(state: UKFState, z: torch.Tensor) -> UKFState:
  """Measurement update; identity measurement fn. z [B,4]."""
  dev = state.x.device
  wm, wc = _weights(dev)
  pts = _sigma_points(state.x, state.P)
  zm = _angle_mean(pts, wm)
  dz = _residual(pts, zm[:, None])
  S = torch.einsum("s,bsi,bsj->bij", wc, dz, dz) + _diag(R_DIAG, dev)
  dx = _residual(pts, state.x[:, None])
  C = torch.einsum("s,bsi,bsj->bij", wc, dx, dz)
  K, _ = torch.linalg.solve_ex(S.transpose(-1, -2), C.transpose(-1, -2))
  K = K.transpose(-1, -2)
  innov = _residual(z, zm)
  x = state.x + torch.einsum("bij,bj->bi", K, innov)
  x = torch.cat([x[:, :2], normalize_angle(x[:, 2:3]), x[:, 3:]], -1)
  P = state.P - torch.einsum("bij,bjk,blk->bil", K, S, K)
  P = 0.5 * (P + P.transpose(-1, -2)) + 1e-6 * torch.eye(N, device=dev)
  init = state.initialized
  x = torch.where(init[:, None], x, z)
  P = torch.where(init[:, None, None], P, _diag(P0_DIAG, dev).expand_as(P))
  return UKFState(x=x, P=P, initialized=torch.ones_like(init))
