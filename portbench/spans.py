"""Host ranges around calls into the program, opened from the
benchmark's own files.

A per-layer reader that needs a range declares ``SPAN = (module,
attribute)``: the program's module that makes the call and the name it
calls. In a traced run the driver replaces that name in that module with
a wrapper that opens ``record_function("portbench.<attribute>")`` and,
while the profiler runs, keeps a copy of the call's tensor arguments for
the reader (copied outside the range). Untraced runs install nothing.
"""

from __future__ import annotations

import importlib

import torch

from portbench.common import clone_tree


class Spans:
  def __init__(self):
    self.calls = {}           # attribute -> [copied args] while recording
    self.recording = False
    self._undo = []

  def install(self, readers: dict):
    for reader in readers.values():
      span = getattr(reader, "SPAN", None)
      if span is None or span[1] in self.calls:
        continue
      mod = importlib.import_module(span[0])
      real = getattr(mod, span[1])
      self.calls[span[1]] = []
      setattr(mod, span[1], self._wrap(span[1], real))
      self._undo.append((mod, span[1], real))

  def _wrap(self, name: str, real):
    def wrapper(*args, **kwargs):
      if self.recording:
        self.calls[name].append((clone_tree(args), clone_tree(kwargs)))
      with torch.profiler.record_function(f"portbench.{name}"):
        return real(*args, **kwargs)
    return wrapper

  def uninstall(self):
    for mod, name, real in reversed(self._undo):
      setattr(mod, name, real)
    self._undo.clear()
