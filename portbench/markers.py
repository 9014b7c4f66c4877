"""Program spans inside a replayed CUDA graph, read from the traced
stretch.

A span that the program opens while a CUDA graph is captured records
nothing on the host; it puts two empty kernels into the graph instead,
``cgt_span_begin<id>`` and ``cgt_span_end<id>``
(``carla_garage_tpu_torch.utils.profiling``, whose ``marker_ids()`` maps
each span's name to its id), so that every replay runs them around the
span's work. The trace names each kernel of a replay and gives them all
the correlation id of the replay's launch: ``replays_ms`` sums, replay by
replay, the device time of the operations between a begin marker of the
span and the next end marker of it. A program without the markers, or a
stretch without a replay that ran them, gives nothing.
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict

from portbench.common import percentile
from portbench.program_spans import _profiling

MARK = re.compile(r"cgt_span_(begin|end)<(\d+)>")


def marker_id(name: str):
  """The marker id of the program's span `name`; None where the program
  has no markers or the span never marked a graph."""
  ids = getattr(_profiling(), "marker_ids", None)
  return None if ids is None else ids().get(name)


def replays_ms(device_ops, marker: int) -> list:
  """[ms] a replay, in time order: the device operations [(ts, dur us,
  name, correlation)] of each launch (one correlation id), summed between
  a begin and the next end marker of `marker`; marker kernels themselves
  are not counted, and a launch without that marker is left out."""
  by = defaultdict(list)
  for ts, dur, name, corr in device_ops:
    by[corr].append((ts, dur, name))
  out = []
  for ops in sorted(sorted(ops) for ops in by.values()):
    inside, seen, total = False, False, 0.0
    for _, dur, name in ops:
      m = MARK.search(name)
      if m:
        if int(m.group(2)) == marker:
          inside, seen = m.group(1) == "begin", True
        continue
      if inside:
        total += dur
    if seen:
      out.append(total * 1e-3)
  return out


def span_replays_ms(rec: dict, name: str, label: str):
  """[ms] a replay of the span `name` in the record's traced stretch (the
  count, median and p95 to standard error); None without them."""
  tr = rec.get("trace")
  marker = marker_id(name)
  if tr is None or marker is None:
    return None
  ms = replays_ms(tr.device_ops, marker)
  if not ms:
    return None
  print(f"{label}: {len(ms)} replays, median {percentile(ms, 50)!r}, "
        f"p95 {percentile(ms, 95)!r}", file=sys.stderr)
  return ms
