"""Learning-rate schedules and learned multi-task loss weighting (port of
carla_garage_tpu/train/schedules.py, with the port's copies of
``make_schedule`` and ``SPEED_WEIGHTS``, whose JAX home is
carla_garage_tpu/train/plant_train.py).

A schedule here is a function from the update count (the number of
optimizer updates already applied) to a learning-rate factor, for
``torch.optim.lr_scheduler.LambdaLR`` stepped once after each
``optimizer.step()``: the learning rate of an update is the base rate
times the factor, the value optax's schedule gives at the same count.
"""

from __future__ import annotations

import math

import torch

# Target-speed class weights (config.py:158)
SPEED_WEIGHTS = (0.866605263873406, 7.4527377240841775, 1.2281629310898465,
                 0.5269622904065803)


def multistep_schedule(steps_per_epoch: int, milestones=(30, 40),
                       decay: float = 0.1):
  """MultiStepLR (train.py:588-592): the factor decays by `decay` once the
  count reaches each milestone (optax ``piecewise_constant_schedule``;
  milestones that fall on the same step count once, as the JAX package's
  dict of boundaries does)."""
  boundaries = sorted({int(m * steps_per_epoch): decay
                       for m in milestones}.items())

  def factor(count: int) -> float:
    f = 1.0
    for threshold, scale in boundaries:
      if count >= threshold:
        f *= scale
    return f

  return factor


def cosine_restart_schedule(steps_per_epoch: int, t0_epochs: int = 1,
                            t_mult: int = 2, n_cycles: int = 8):
  """SGDR (train.py:593-598): cosine cycles of t0 * t_mult^k epochs, each
  from 1 down to 0 (optax ``cosine_decay_schedule`` joined by
  ``join_schedules``; past the last cycle the last one stays at 0)."""
  starts, lengths = [], []
  total, length = 0, t0_epochs * steps_per_epoch
  for _ in range(n_cycles):
    starts.append(total)
    lengths.append(length)
    total += length
    length *= t_mult

  def factor(count: int) -> float:
    i = max(j for j, s in enumerate(starts) if count >= s)
    t = min(count - starts[i], lengths[i])
    return 0.5 * (1.0 + math.cos(math.pi * t / lengths[i]))

  return factor


def make_schedule(schedule: str | None, steps: int):
  """The schedule wiring of train.py:588-598 as a LambdaLR factor:
  'multistep' decays 0.1x at the reference's 30/40-of-47-epoch milestones
  mapped to step fractions (0.64/0.85); 'cosine_restart' is SGDR t0=1,
  t_mult=2; None is constant."""
  if schedule == "multistep":
    return multistep_schedule(
        steps_per_epoch=1,
        milestones=(max(int(0.64 * steps), 1), max(int(0.85 * steps), 2)))
  if schedule == "cosine_restart":
    return cosine_restart_schedule(steps_per_epoch=max(steps // 127, 1))
  if schedule is None:
    return lambda count: 1.0
  raise ValueError(f"unknown schedule {schedule!r}")


def uncertainty_weighted_total(losses: dict, log_vars: dict, mesh=None):
  """Kendall multi-task weighting: sum exp(-s_i) L_i + s_i (the learned
  alternative to fixed loss weights, train.py:384-456). Loss keys without
  a learned variance fall back to unit weight. Under a data-parallel mesh
  the losses are the rank's shares, and each rank adds s_i / n, so that
  the ranks' totals sum to the global total with s_i counted once."""
  total = 0.0
  for k, v in losses.items():
    s = log_vars.get(k)
    if s is None:
      total = total + v
    else:
      total = total + torch.exp(-s) * v + (s if mesh is None
                                           else s / mesh.size)
  return total


def init_log_vars(loss_keys, device="cuda") -> dict:
  """One zero log-variance per loss key, as trainable parameters."""
  from portbench.reference.cgt.device import resolve_device
  dev = resolve_device(device)
  return {k: torch.nn.Parameter(torch.zeros((), device=dev))
          for k in loss_keys}
