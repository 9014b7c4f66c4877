"""backward_ms.train: the backward pass: the program's span
``train.backward`` (``loss.backward()``); the median over the window's
steps outside the traced stretch of the span's CUDA-event time in each
(``program_spans.layer_ms``). Importing this file turns the program's
recorder on."""

from portbench import program_spans

program_spans.turn_on()


def read(rec):
  return program_spans.layer_ms(rec, "train", "train.backward", "backward_ms")
