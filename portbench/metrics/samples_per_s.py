"""samples_per_s: training samples stepped over the whole window (from its
start to the sync after its last step)."""

import sys

from portbench.common import percentile


def read(rec):
  if rec.get("kind") != "train" or rec["window_s"] <= 0:
    return None
  steps = rec.get("step_ms") or []
  if steps:
    print(f"step_ms: {len(steps)} steps, median {percentile(steps, 50)!r}, "
          f"min {min(steps)!r}, max {max(steps)!r}", file=sys.stderr)
  return rec["samples"] / rec["window_s"]
