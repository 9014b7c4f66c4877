"""Profiling (port of carla_garage_tpu/utils/profiling.py) and the
program's own spans.

- ``trace(dir)``: a ``torch.profiler`` context over the host and the card
  that writes a Chrome trace (``trace.json``) into `dir`.
- ``span(name)``: a named range around one of the program's layers
  (``sim.tick``, ``agent.model``, ``train.backward``, ...). Spans are off
  by default, and then a span costs one flag check: it allocates nothing,
  opens no ``record_function`` and records no CUDA event. They are live
  while the recorder is on (``record(True)``) or inside ``trace()``:
  then, while a ``torch.profiler`` runs, each span opens a
  ``record_function`` range ``cgt.<name>``, which the Chrome trace places
  on the profiler's clock beside the operations and kernel launches made
  inside it; and while the recorder is on, each span is kept in memory as
  a ``Span`` (``recorded()``), until ``clear()``. Nothing is written to
  disk. Spans are opened and closed on one thread. A span may carry a
  count of what it produced (``span(name, count=n)``).
- Inside a CUDA graph's stream capture a live span records nothing: it
  puts two empty marker kernels into the graph instead, at its opening
  and its close (``csrc/span_markers.cu``: ``cgt_span_begin<id>`` and
  ``cgt_span_end<id>``, id from ``marker_ids()``), so that every replay
  of the graph runs them around the span's work and a profiler's trace
  shows where it began and ended. ``capturing(marks)`` goes around a
  capture (``utils/cuda_graph.py``) and, where the captured code opens
  spans (its warm-up opened some: ``opened()``), loads the markers before
  it begins; a graph captured while spans are off, or of code that opens
  none, holds none.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

PREFIX = "cgt."          # the profiler's name of a span is PREFIX + name

_live = False            # the one flag a span checks
_recording = False
_tracing = 0             # trace() contexts open
_cuda = False            # record CUDA events (a card is present)
_spans = []              # recorded spans, in the order they opened
_stack = []              # the recorded spans open now, innermost last
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()
_capture = False         # inside capturing()
_opened = 0              # live spans opened so far
_markers = None          # the marker kernels' library, once loaded
_marker_ids = {}         # span name -> marker id, as spans first mark
_counters = {}           # counter name -> device tensor (``counter``)


class Span:
  """One recorded span. root is the id of the outermost recorded span
  around it (itself for a root such as ``sim.tick`` or ``train.step``):
  the spans of one tick or step share it. start_ns and end_ns are host
  times on the profiler's clock (Unix time in ns, as the Chrome trace's
  ``ts`` in us plus its ``baseTimeNanoseconds``); end_ns is None while
  the span is open. events: CUDA events at both ends on the current
  stream, on a card, else None."""

  __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
               "events", "count")

  def __init__(self, name: str, parent: "Span | None", count=None):
    self.name = name
    self.count = count
    self.id = next(_ids)
    self.parent = None if parent is None else parent.id
    self.root = self.id if parent is None else parent.root
    self.start_ns = self.end_ns = None
    self.events = None

  def elapsed_ms(self) -> float:
    """The span's duration: between its CUDA events (the stream's time,
    read after the work is done), else on the host clock."""
    if self.events is not None:
      return self.events[0].elapsed_time(self.events[1])
    return (self.end_ns - self.start_ns) * 1e-6


class _Live:
  """A live span: the profiler's range, the recorded Span, or both."""

  __slots__ = ("name", "count", "rec", "rng")

  def __init__(self, name: str, count=None):
    self.name = name
    self.count = count
    self.rec = self.rng = None

  def __enter__(self):
    if torch.autograd._profiler_enabled():
      self.rng = torch.profiler.record_function(PREFIX + self.name)
      self.rng.__enter__()
    if _recording:
      rec = self.rec = Span(self.name, _stack[-1] if _stack else None,
                            self.count)
      _spans.append(rec)
      _stack.append(rec)
      if _cuda:
        rec.events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        rec.events[0].record()
      rec.start_ns = time.time_ns()
    return self

  def __exit__(self, *exc):
    rec = self.rec
    if rec is not None:
      rec.end_ns = time.time_ns()
      if rec.events is not None:
        rec.events[1].record()
      _stack.remove(rec)
    if self.rng is not None:
      self.rng.__exit__(*exc)
    return False


class _Marked:
  """A live span inside a stream capture: marker kernels at both ends."""

  __slots__ = ("id",)

  def __init__(self, name: str):
    if name not in _marker_ids:
      if len(_marker_ids) == _markers.span_marker_count():
        raise RuntimeError(f"no marker left for span {name!r}")
      _marker_ids[name] = len(_marker_ids)
    self.id = _marker_ids[name]

  def _launch(self, end: int):
    err = _markers.span_marker_launch(
        self.id, end, torch.cuda.current_stream().cuda_stream)
    if err != 0:
      raise RuntimeError(f"span marker launch failed: CUDA error {err}")

  def __enter__(self):
    self._launch(0)
    return self

  def __exit__(self, *exc):
    self._launch(1)
    return False


def span(name: str, count=None):
  """A context manager around one layer of the program (see the module's
  docstring); count: what the span produced (frames, rows, ...)."""
  global _opened
  if not _live:
    return _OFF
  if _capture:
    return _OFF if _markers is None else _Marked(name)
  _opened += 1
  return _Live(name, count)


def opened() -> int:
  """The number of live spans opened so far, outside captures."""
  return _opened


@contextlib.contextmanager
def capturing(marks: bool):
  """Around a CUDA graph's stream capture. marks: the captured code opens
  spans; then, while spans are live, the marker kernels are loaded first
  (built on first use) and the spans opened inside mark the graph. Spans
  opened inside record nothing in any case."""
  global _capture
  if marks and _live:
    _load_markers()
  _capture = True
  try:
    yield
  finally:
    _capture = False


def _load_markers():
  global _markers
  if _markers is not None:
    return
  import ctypes
  from carla_garage_tpu_torch.ops.build import load_kernel
  lib = load_kernel("span_markers")
  lib.span_marker_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
  lib.span_marker_launch.restype = ctypes.c_int
  lib.span_marker_count.restype = ctypes.c_int
  lib.span_marker_load.restype = ctypes.c_int
  err = lib.span_marker_load()
  if err != 0:
    raise RuntimeError(f"span markers failed to load: CUDA error {err}")
  _markers = lib


def counter(name: str, value: torch.Tensor) -> torch.Tensor:
  """Name a device tensor that the program keeps up to date in place (a
  count that a graph replay adds to, with no host sync), for a reader to
  take after the run; returns it. Costs a dict entry, recorder on or
  off."""
  _counters[name] = value
  return value


def counters() -> dict:
  """{name: tensor} of the program's counters (``counter``)."""
  return dict(_counters)


def marker_ids() -> dict:
  """{span name: marker id} of the spans that marked a captured graph."""
  return dict(_marker_ids)


def _update():
  global _live
  _live = _recording or _tracing > 0


def record(on: bool = True):
  """Turn the recorder on or off. Turning it on again changes nothing and
  never drops what was recorded (``clear()`` does)."""
  global _recording, _cuda
  if on and not _recording:
    _cuda = torch.cuda.is_available()
  _recording = bool(on)
  _update()


def recording() -> bool:
  return _recording


def recorded() -> list:
  """The recorded spans, in the order they opened."""
  return list(_spans)


def clear():
  """Drop every recorded span."""
  _spans.clear()


@contextlib.contextmanager
def trace(log_dir: str):
  """Profile the block (CPU, and CUDA when a card is present) and write
  its Chrome trace to `log_dir`/trace.json, with the program's spans as
  ``cgt.*`` ranges. Yields the profiler."""
  global _tracing
  from torch.profiler import ProfilerActivity, profile
  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  _tracing += 1
  _update()
  try:
    with profile(activities=acts) as prof:
      yield prof
      if torch.cuda.is_available():
        torch.cuda.synchronize()
  finally:
    _tracing -= 1
    _update()
  prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
