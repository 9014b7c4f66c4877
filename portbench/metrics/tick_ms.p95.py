"""tick_ms.p95: the 95th percentile of every tick of the window, each the
gap between CUDA events at consecutive policy entries (the device's
waits for the host included)."""

import sys

from portbench.common import percentile


def read(rec):
  ticks = rec.get("tick_ms") if rec.get("kind") == "eval" else None
  if not ticks:
    return None
  p95 = percentile(ticks, 95)
  beyond = sum(t > p95 for t in ticks)
  print(f"tick_ms: {len(ticks)} ticks, median {percentile(ticks, 50)!r}, "
        f"p95 {p95!r} with {beyond} beyond", file=sys.stderr)
  return p95
