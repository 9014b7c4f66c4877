"""inputs_ms.eval: the model's inputs: the program's span ``agent.inputs``
(TransFuser++: camera, LiDAR half sweep, realignment, voxelize, with B1's
launches; PlanT: objects, route tokens and flags); the median over the
window's ticks outside the traced stretch of the span's CUDA-event time in
each (``program_spans.layer_ms``). Importing this file turns the program's
recorder on."""

from portbench import program_spans

program_spans.turn_on()


def read(rec):
  return program_spans.layer_ms(rec, "eval", "agent.inputs", "inputs_ms")
