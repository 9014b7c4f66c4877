"""vision_ms.eval: SimLingo's vision tower through the projector: the
device time of the program's span ``model.vision`` (the patch embedding,
the 24 InternViT layers over every tile, the pixel shuffle and the MLP
projector) in a forward. On the card the forward replays as a CUDA graph
and the span is a pair of marker kernels in it: the median over the
traced stretch's replays of the kernels between them
(``markers.span_replays_ms``). In an eager forward (no graph) it is the
ordinary span: the median over the window's ticks outside the traced
stretch of its CUDA-event time (``program_spans.layer_ms``). The span's
count (the tiles a forward) goes to standard error. None in a run of
another configuration (its forward FLOPs differ). Importing this file
turns the program's recorder on."""

import sys

from portbench import harness, markers, program_spans
from portbench.common import percentile

program_spans.turn_on()

NAME = "model.vision"
CONFIG = "simlingo"


def read(rec):
  if rec.get("kind") != "eval" or rec.get("flops_per_sample") != \
      harness.load_config(CONFIG).CONFIG["forward_flops_per_sample"]:
    return None
  counts = sorted({s.count for s in program_spans.recorded()
                   if s.name == NAME})
  print(f"vision_ms: {NAME} counts {counts}", file=sys.stderr)
  ms = markers.span_replays_ms(rec, NAME, "vision_ms")
  if ms:
    return percentile(ms, 50)
  return program_spans.layer_ms(rec, "eval", NAME, "vision_ms")
