"""Profiling (port of carla_garage_tpu/utils/profiling.py).

- ``trace(dir)``: a ``torch.profiler`` context over the host and the card
  that writes a Chrome trace (``trace.json``) into `dir`.
- ``Throughput``: an env-steps/s counter, and its rate per card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
  """Profile the block (CPU, and CUDA when a card is present) and write
  its Chrome trace to `log_dir`/trace.json. Yields the profiler."""
  from torch.profiler import ProfilerActivity, profile
  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with profile(activities=acts) as prof:
    yield prof
    if torch.cuda.is_available():
      torch.cuda.synchronize()
  prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
  """Running env-steps/s counter. The caller synchronizes the card before
  reading a rate."""

  def __init__(self):
    self.t0 = time.perf_counter()
    self.steps = 0

  def add(self, env_steps: int):
    self.steps += env_steps

  @property
  def per_sec(self) -> float:
    dt = time.perf_counter() - self.t0
    return self.steps / dt if dt > 0 else 0.0

  def per_chip(self) -> float:
    """The rate of this process' card. A port process drives one card (a
    data-parallel rank its own), whatever the host holds, so this is the
    process' rate."""
    return self.per_sec
