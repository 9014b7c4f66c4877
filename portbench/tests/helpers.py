"""Tiny CPU runs of the harness for the tests: the tests' small sizes of
each configuration and a few ticks or steps of each cell."""

from __future__ import annotations

import time

from portbench import harness

SEED = 12345678901            # larger than 32 signed bits
TINY = {
    "tfpp.eval": {"batch": 2, "chunk": 4, "check_within": 8,
                  "check_ticks": 2, "profile_at": 2, "profile_ticks": 2},
    "plant.eval": {"batch": 2, "chunk": 4, "check_within": 8,
                   "check_ticks": 2, "profile_at": 2, "profile_ticks": 2},
    "tfpp.train": {"batch": 2, "frames": 3, "micro_batches": 2,
                   "profile_at": 1, "profile_steps": 1},
    "plant.train": {"episodes": 4, "frames": 12, "batch_size": 8,
                    "profile_at": 1, "profile_steps": 1},
}


def tiny_run(cell: str, trace: bool = False, seconds: float = 0.5,
             seed: int = SEED) -> dict:
  """A whole run of `cell` at the tests' sizes on the CPU, without the
  look for a card."""
  return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                          device="cpu", small=True,
                          traffic_override=TINY[cell], check_cards=False)


# a cell kept out of BENCHMARK.json (its runs spread too far to bound; see
# PERF.md), whose files stay and whose check the tests still drive
KEPT_OUT = {"tfpp.train": {"name": "tfpp.train", "config": "tfpp",
                           "traffic": "train_frames_4x16", "chips": 1}}


def context(cell: str, seed: int = SEED):
  return harness.make_context(cell, seed, False, device="cpu", small=True,
                              traffic_override=TINY[cell],
                              entry=KEPT_OUT.get(cell))[0]


def tiny_values(cell: str, mutate_ctx=None, seconds: float = 0.3) -> dict:
  """The compared numbers of a tiny run (no limits), with `mutate_ctx`
  applied to the context before set-up."""
  ctx = context(cell)
  if mutate_ctx is not None:
    mutate_ctx(ctx)
  harness.point_caches()
  drv = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
  drv.setup()
  drv.window(seconds)
  drv.release()
  return drv.check()
