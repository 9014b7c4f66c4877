"""scenarios_ms.eval: the scenario engine: the program's span
``sim.scenarios`` (``scenario_step``); the median over the window's ticks
outside the traced stretch of the span's CUDA-event time in each
(``program_spans.layer_ms``). Importing this file turns the program's
recorder on."""

from portbench import program_spans

program_spans.turn_on()


def read(rec):
  return program_spans.layer_ms(rec, "eval", "sim.scenarios", "scenarios_ms")
