"""model_ms.eval: the model: the program's span ``agent.model`` (the forward
with its bf16 casts and the ensemble's mean); the median over the window's
ticks outside the traced stretch of the span's CUDA-event time in each
(``program_spans.layer_ms``). Importing this file turns the program's
recorder on."""

from portbench import program_spans

program_spans.turn_on()


def read(rec):
  return program_spans.layer_ms(rec, "eval", "agent.model", "model_ms")
