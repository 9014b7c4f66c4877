"""sim_ms.eval: the median over the window's ticks outside the traced
stretch of the tick's gap less its policy span (scenarios, dynamics,
traffic, walkers, criteria and the chunk's done check)."""

import sys

from portbench.common import percentile


def read(rec):
  if rec.get("kind") != "eval":
    return None
  xs = [t - p for i, (t, p) in enumerate(zip(rec["tick_ms"],
                                              rec["policy_ms"]))
        if i not in rec["traced"]]
  if not xs:
    return None
  print(f"sim_ms: {len(xs)} ticks, median {percentile(xs, 50)!r}, "
        f"p95 {percentile(xs, 95)!r}", file=sys.stderr)
  return percentile(xs, 50)
