"""traffic_ms.eval: NPC traffic and walkers: the program's span
``sim.traffic`` (``traffic_step`` and ``walker_step``); the median over
the window's ticks outside the traced stretch of the span's CUDA-event
time in each (``program_spans.layer_ms``). Importing this file turns the
program's recorder on."""

from portbench import program_spans

program_spans.turn_on()


def read(rec):
  return program_spans.layer_ms(rec, "eval", "sim.traffic", "traffic_ms")
