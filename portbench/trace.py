"""The traced stretch: ``torch.profiler`` over a fixed count of ticks or
steps, written as a Chrome trace under ``build/portbench/traces/`` and
read back into device intervals, host ranges and launches.

Every range the benchmark opens is a ``record_function`` whose name
starts with ``portbench.``. A kernel belongs to a range when the runtime
call that launched it ran inside the range on the same host thread, so a
renamed or fused kernel that the same call launches is still counted.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

import torch

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class Profiler:
  """Start and stop the profiler at tick or step boundaries; the stretch
  ends in a synchronize, so its device work is inside the trace."""

  def __init__(self, path: Path):
    self.path = Path(path)
    self.prof = None
    self.active = False

  def start(self):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
      acts.append(ProfilerActivity.CUDA)
    self.prof = profile(activities=acts)
    self.prof.__enter__()
    self.active = True

  def stop(self):
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    self.prof.__exit__(None, None, None)
    self.active = False

  def read(self) -> "Trace":
    self.path.parent.mkdir(parents=True, exist_ok=True)
    self.prof.export_chrome_trace(str(self.path))
    self.prof = None
    return Trace.load(self.path)


def merge(intervals):
  """Sorted, disjoint union of (start, end) intervals."""
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


class Trace:
  """Device operations, runtime launches and the benchmark's host ranges
  of one traced stretch (times in microseconds as the trace has them)."""

  def __init__(self, device_ops, launches, ranges, cpu_ops):
    self.device_ops = device_ops  # [(ts, dur, name, correlation)]
    self.launches = launches      # {correlation: (ts, tid)}
    self.ranges = ranges          # [(name, ts, dur, tid)] portbench.*
    self.cpu_ops = cpu_ops        # [(name, ts, dur, tid)] torch ops
    starts = [r[1] for r in ranges if r[0] == PREFIX + "stretch"]
    ends = [r[1] + r[2] for r in ranges if r[0] == PREFIX + "stretch"]
    dev_end = max((t + d for t, d, _, _ in device_ops), default=0.0)
    self.t0 = min(starts) if starts else \
        min((t for t, _, _, _ in device_ops), default=0.0)
    self.t1 = max(max(ends, default=0.0), dev_end)
    self._ranges_sorted = sorted(ranges, key=lambda r: r[1])
    self._range_starts = [r[1] for r in self._ranges_sorted]
    self._ops_sorted = sorted(cpu_ops, key=lambda r: r[1])
    self._op_starts = [r[1] for r in self._ops_sorted]
    self.busy = [(max(s, self.t0), min(e, self.t1)) for s, e in
                 merge((t, t + d) for t, d, _, _ in device_ops)
                 if e > self.t0 and s < self.t1]

  @classmethod
  def load(cls, path: Path) -> "Trace":
    events = json.loads(Path(path).read_text())["traceEvents"]
    device_ops, launches, ranges, cpu_ops = [], {}, [], []
    for ev in events:
      if ev.get("ph") != "X":
        continue
      cat = ev.get("cat", "")
      args = ev.get("args") or {}
      ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
      if cat in DEVICE_CATS:
        device_ops.append((ts, dur, ev["name"], args.get("correlation")))
      elif cat in RUNTIME_CATS:
        if args.get("correlation") is not None:
          launches[args["correlation"]] = (ts, ev["tid"])
      elif cat == "user_annotation" and ev["name"].startswith(PREFIX):
        ranges.append((ev["name"], ts, dur, ev["tid"]))
      elif cat == "cpu_op":
        cpu_ops.append((ev["name"], ts, dur, ev["tid"]))
    return cls(device_ops, launches, ranges, cpu_ops)

  @property
  def window_s(self) -> float:
    return (self.t1 - self.t0) * 1e-6

  @property
  def busy_s(self) -> float:
    return sum(e - s for s, e in self.busy) * 1e-6

  def idle_share(self) -> float | None:
    if self.window_s <= 0 or not self.device_ops:
      return None
    return 1.0 - self.busy_s / self.window_s

  def range_device_s(self, name: str) -> tuple:
    """(device seconds, kernel count) of every device operation launched
    inside a host range called `name`."""
    spans = [(ts, ts + dur, tid) for n, ts, dur, tid in self.ranges
             if n == name]
    total, n = 0.0, 0
    for ts, dur, _, corr in self.device_ops:
      at = self.launches.get(corr)
      if at is None:
        continue
      t, tid = at
      if any(s <= t <= e and tid == st for s, e, st in spans):
        total += dur
        n += 1
    return total * 1e-6, n

  def top_ops(self, k: int) -> list:
    """The k device operations that took the most time, summed by name."""
    by = {}
    for _, dur, name, _ in self.device_ops:
      by[name[:120]] = by.get(name[:120], 0.0) + dur * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

  @staticmethod
  def _innermost(items, starts, t: float, back: int = 64):
    """The shortest of `items` (sorted by start) that holds time t,
    looking back over the `back` latest to start before it."""
    best = None
    j = bisect.bisect_right(starts, t)
    for name, ts, dur, _ in items[max(0, j - back):j]:
      if t <= ts + dur and (best is None or dur < best[1]):
        best = (name, dur)
    return None if best is None else best[0]

  def _label(self, t: float) -> str:
    """What the host was doing at time t: the innermost benchmark range
    around it and the torch operation inside that range, if any."""
    rng = self._innermost(self._ranges_sorted, self._range_starts, t)
    rng = rng[len(PREFIX):] if rng else "outside"
    op = self._innermost(self._ops_sorted, self._op_starts, t)
    return rng if op is None else f"{rng}/{op}"

  def idle_by_host(self, k: int) -> list:
    """Idle device time in the stretch, summed by what the host was doing
    when each gap closed (the launch of the operation that ended it): the
    k largest sums."""
    starts = [t for t, _, _, _ in self.device_ops]
    order = sorted(range(len(self.device_ops)), key=starts.__getitem__)
    sorted_starts = [starts[i] for i in order]
    by = {}
    prev = self.t0
    for s, e in self.busy + [(self.t1, self.t1)]:
      gap = s - prev
      if gap > 0:
        j = bisect.bisect_left(sorted_starts, s)
        t = s
        if j < len(order):
          corr = self.device_ops[order[j]][3]
          t = self.launches.get(corr, (s, None))[0]
        label = self._label(t)
        by[label] = by.get(label, 0.0) + gap * 1e-6
      prev = max(prev, e)
    return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]
