"""Importing a reader of the program's spans turns the program's recorder
on (``program_spans.turn_on``); each test leaves the recorder as it found
it."""

import pytest


@pytest.fixture(autouse=True)
def _program_recorder():
  try:
    from carla_garage_tpu_torch.utils import profiling
  except ImportError:
    profiling = None
  if not hasattr(profiling, "record"):
    yield
    return
  was = profiling.recording()
  yield
  profiling.record(was)
  if not was:
    profiling.clear()
