"""The program's own spans, for the per-layer readers that read them.

The program (``carla_garage_tpu_torch.utils.profiling``) keeps a span
around each of its layers while its recorder is on (``sim.tick`` around
``sim.policy``, ``agent.*``, ``sim.scenarios`` ...; ``train.step`` around
``train.forward`` ...), each with CUDA events at both ends, and opens a
``record_function`` range ``cgt.<name>`` for each while the profiler
runs. Readers load only in traced runs, before set-up, and a reader that
imports this module turns the recorder on (``turn_on``). A program
without the recorder records nothing and has no ``cgt.*`` range: the
readers then return None.

Times (``layer_ms``): the window's ticks (or steps) are the root spans
(``sim.tick``, ``train.step``) whose host start lies in the window,
numbered in order as the benchmark's loops number the window's ticks and
steps (``rec["tick_ms"]``, ``rec["step_ms"]``); those the profiler's
start and stop touch (``rec["traced"]``, and in closed loop the tick
after them: the profiler starts and stops inside the policy, so inside
the program's tick) are left out. A layer's time in a tick is the
CUDA-event time of its spans with that tick's id; a reader takes the
median over the ticks.

Launches (``launches_per_root``, ``print_table``): the ``cgt.*`` ranges
come from the stretch's Chrome trace under ``build/portbench/traces/``
(``trace.Trace`` keeps only the benchmark's ranges), the file whose
``portbench.stretch`` range starts at the record's ``trace.t0``; a range
cut by the profiler's start or stop is left out. A launch is one runtime
call whose correlation id has at least one device operation (a CUDA
graph's launch counts once), placed as ``Trace.range_device_s`` places
it: by the runtime call's host time and thread, here in the innermost
``cgt.*`` range; a launch from a thread that opens no span (autograd's
backward thread) by its host time alone.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from collections import defaultdict

from portbench import harness
from portbench.common import percentile
from portbench.trace import PREFIX as BENCH_PREFIX

PREFIX = "cgt."
ROOTS = {"eval": "sim.tick", "train": "train.step"}
START_MARGIN_NS = 1_000_000   # a window tick starts at most this long
                              # before the window's own start reads (the
                              # two clocks are read at different times)


def _profiling():
  try:
    from carla_garage_tpu_torch.utils import profiling
  except ImportError:
    return None
  return profiling


def turn_on():
  """Turn the program's recorder on, where the program has one."""
  record = getattr(_profiling(), "record", None)
  if record is not None:
    record(True)


def recorded() -> list:
  """The program's recorded spans (none without a recorder)."""
  get = getattr(_profiling(), "recorded", None)
  return [] if get is None else get()


def window_roots(rec: dict, root: str, spans: list) -> list:
  """The root spans named `root` that began in the window, in order."""
  shift = time.time_ns() - time.perf_counter_ns()
  lo = int(rec["window_start"] * 1e9) + shift - START_MARGIN_NS
  hi = lo + START_MARGIN_NS + int(rec["window_s"] * 1e9)
  return [s for s in spans if s.name == root and s.parent is None and
          s.end_ns is not None and lo <= s.start_ns <= hi]


def layer_ms(rec: dict, kind: str, name: str, label: str):
  """The median over the window's ticks or steps outside the traced
  stretch of the time of the spans `name` in each (those that have one);
  the count, median and p95 go to standard error. None where the run is
  of another kind or the program has no such span."""
  if rec.get("kind") != kind:
    return None
  spans = recorded()
  roots = window_roots(rec, ROOTS[kind], spans)
  skip = set(rec["traced"])
  if kind == "eval":
    skip |= {i + 1 for i in skip}
  keep = {r.id for i, r in enumerate(roots) if i not in skip}
  per = defaultdict(float)
  for s in spans:
    if s.name == name and s.root in keep and s.end_ns is not None:
      per[s.root] += s.elapsed_ms()
  xs = list(per.values())
  if not xs:
    return None
  unit = "ticks" if kind == "eval" else "steps"
  print(f"{label}: {len(xs)} {unit} of {len(roots)}, median "
        f"{percentile(xs, 50)!r}, p95 {percentile(xs, 95)!r}",
        file=sys.stderr)
  return percentile(xs, 50)


# --- the stretch's trace ---------------------------------------------------

def program_ranges(rec: dict):
  """The ``cgt.*`` ranges [(name, ts, dur, tid)] that lie whole inside the
  traced stretch, from its Chrome trace; None without a trace or its
  file."""
  tr = rec.get("trace")
  if tr is None:
    return None
  files = sorted((harness.BUILD / "traces").glob("*.json"),
                 key=lambda p: -p.stat().st_mtime)
  for path in files:
    try:
      events = json.loads(path.read_text())["traceEvents"]
    except (OSError, ValueError, KeyError):
      continue
    ranges, stretch = [], None
    for ev in events:
      if ev.get("ph") != "X" or ev.get("cat") != "user_annotation":
        continue
      name, ts = ev["name"], float(ev["ts"])
      if name.startswith(PREFIX):
        ranges.append((name[len(PREFIX):], ts, float(ev.get("dur", 0.0)),
                       ev["tid"]))
      elif name == BENCH_PREFIX + "stretch":
        stretch = (ts, ts + float(ev.get("dur", 0.0)))
    if stretch is None or stretch[0] != tr.t0:
      continue
    return [r for r in ranges
            if r[1] >= stretch[0] and r[1] + r[2] <= stretch[1]]
  return None


def innermost(ranges: list, points: list) -> dict:
  """{key: index into `ranges` or None} for points [(t, tid, key)]: the
  innermost range (ts <= t <= ts + dur) on the point's thread. A point on
  a thread that opens no range (autograd's backward thread, which
  launches the backward's kernels while the caller waits in
  ``loss.backward()``) takes the ranges of every thread. Ranges of one
  thread nest, as spans do."""
  out = {}
  by_tid = defaultdict(list)
  for i, (_, ts, dur, tid) in enumerate(ranges):
    by_tid[tid].append((ts, -dur, i))
  every = sorted(r for rs in by_tid.values() for r in rs)
  pts = defaultdict(list)
  for t, tid, key in points:
    pts[tid].append((t, key))
  for tid, ps in pts.items():
    rs = sorted(by_tid[tid]) if tid in by_tid else every
    stack, j = [], 0
    end = lambda i: ranges[i][1] + ranges[i][2]
    for t, key in sorted(ps, key=lambda p: p[0]):
      while j < len(rs) and rs[j][0] <= t:
        while stack and end(stack[-1]) < rs[j][0]:
          stack.pop()
        stack.append(rs[j][2])
        j += 1
      while stack and end(stack[-1]) < t:
        stack.pop()
      out[key] = stack[-1] if stack else None
  return out


def launches(tr) -> dict:
  """{correlation: (host ts, tid)} of the runtime calls with at least one
  device operation."""
  return {c: tr.launches[c] for _, _, _, c in tr.device_ops
          if c in tr.launches}


def launches_per_root(rec: dict, ranges, root: str):
  """Launches inside the stretch's whole ``cgt.<root>`` ranges (at any
  depth; `ranges` from ``program_ranges``) over the count of those
  ranges; None without them."""
  roots = [r for r in ranges or [] if r[0] == root]
  if not roots:
    return None
  at = innermost(roots, [(t, tid, c) for c, (t, tid) in
                         launches(rec["trace"]).items()])
  n = sum(i is not None for i in at.values())
  return n / len(roots)


def table(rec: dict, ranges):
  """One row per program span in the stretch (`ranges` from
  ``program_ranges``): [name, calls, launches, device ms of those
  launches, idle ms whose gap closed on one of them, device-to-host
  copies], launches outside every span under "(no span)"; None without
  the program's ranges."""
  if not ranges:
    return None
  tr = rec["trace"]
  at = innermost(ranges, [(t, tid, c) for c, (t, tid) in
                          launches(tr).items()])
  name_of = lambda c: "(no span)" if at.get(c) is None else \
      ranges[at[c]][0]
  rows = {}

  def row(name):
    return rows.setdefault(name, [name, 0, 0, 0.0, 0.0, 0])

  for name, *_ in ranges:
    row(name)[1] += 1
  for c in at:
    row(name_of(c))[2] += 1
  for _, dur, op, c in tr.device_ops:
    if c in at:
      r = row(name_of(c))
      r[3] += dur * 1e-3
      r[5] += "DtoH" in op
  # idle time, each gap to the launch of the operation that closed it
  ops = sorted(tr.device_ops)
  starts = [o[0] for o in ops]
  prev = tr.t0
  for s, e in tr.busy:
    if s - prev > 0:
      j = bisect.bisect_left(starts, s)
      if j < len(ops) and ops[j][3] in at:
        row(name_of(ops[j][3]))[4] += (s - prev) * 1e-3
    prev = max(prev, e)
  return sorted(rows.values(), key=lambda r: (-r[2], r[0]))


def print_table(rec: dict, ranges):
  """The table on standard error: the program-level form of the
  breakdown's idle gaps."""
  rows = table(rec, ranges)
  if rows is None:
    return
  print("spans: span calls launches device_ms idle_ms dtoh_copies",
        file=sys.stderr)
  for name, calls, n, dev, idle, d2h in rows:
    print(f"spans: {name} {calls} {n} {dev!r} {idle!r} {d2h}",
          file=sys.stderr)
