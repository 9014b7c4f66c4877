"""Host-side watchdog: hang detection for long device operations (port of
carla_garage_tpu/utils/watchdog.py).

The reference arms thread-timer watchdogs around every simulator tick and
agent call, interrupting the main thread on timeout. Here a hang can only
happen at the host/device boundary (a wedged device, a pathological first
build), so the watchdog wraps host-blocking calls.
"""

from __future__ import annotations

import _thread
import contextlib
import threading


class Watchdog:
  """Raises KeyboardInterrupt on the main thread if not stopped in time."""

  def __init__(self, timeout_s: float):
    self.timeout_s = timeout_s
    self._timer = None
    self.tripped = False

  def _trip(self):
    self.tripped = True
    _thread.interrupt_main()

  def start(self):
    self._timer = threading.Timer(self.timeout_s, self._trip)
    self._timer.daemon = True
    self._timer.start()

  def update(self):
    """Re-arm (call once per completed unit of work)."""
    self.stop()
    self.start()

  def stop(self):
    if self._timer is not None:
      self._timer.cancel()
      self._timer = None


@contextlib.contextmanager
def watchdog(timeout_s: float):
  """A Watchdog armed over the block and stopped when it exits."""
  w = Watchdog(timeout_s)
  w.start()
  try:
    yield w
  finally:
    w.stop()
