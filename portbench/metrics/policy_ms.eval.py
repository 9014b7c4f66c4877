"""policy_ms.eval: the median over the window's ticks outside the traced
stretch of the policy's span (CUDA events at the wrapped policy's entry
and return); the median and p95 go to standard error."""

import sys

from portbench.common import percentile


def outside(rec, key):
  return [v for i, v in enumerate(rec.get(key) or [])
          if i not in rec["traced"]]


def read(rec):
  if rec.get("kind") != "eval":
    return None
  xs = outside(rec, "policy_ms")
  if not xs:
    return None
  print(f"policy_ms: {len(xs)} ticks, median {percentile(xs, 50)!r}, "
        f"p95 {percentile(xs, 95)!r}", file=sys.stderr)
  return percentile(xs, 50)
