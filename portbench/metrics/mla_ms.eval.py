"""mla_ms.eval: Kimi-VL's 27 latent-attention layers (projections,
latent norm, RoPE, attention, output projection), summed over the
layers: the device time of the program's span ``model.mla`` in a
forward. On the card the forward replays as a CUDA graph and the span is
a pair of marker kernels in it, once a layer: the median over the traced
stretch's replays of the kernels between each pair, summed over the
pairs of a replay (``markers.span_replays_ms``). In an eager forward (no
graph) it is the ordinary span: the median over the window's ticks
outside the traced stretch of its CUDA-event time, summed over a tick
(``program_spans.layer_ms``). The span's count (the tokens a layer,
9,328 at B=16) goes to standard error. None in a run of another
configuration (its forward FLOPs differ). Importing this file turns the
program's recorder on."""

import sys

from portbench import harness, markers, program_spans
from portbench.common import percentile

program_spans.turn_on()

NAME = "model.mla"
CONFIG = "kimi_vl"


def read(rec):
  config = harness.load_config(CONFIG)
  if rec.get("kind") != "eval" or rec.get("flops_per_sample") != \
      config.CONFIG["forward_flops_per_sample"]:
    return None
  counts = sorted({s.count for s in program_spans.recorded()
                   if s.name == NAME})
  print(f"mla_ms.eval: {NAME} counts {counts}", file=sys.stderr)
  ms = markers.span_replays_ms(rec, NAME, "mla_ms.eval")
  if ms:
    return percentile(ms, 50)
  return program_spans.layer_ms(rec, "eval", NAME, "mla_ms.eval")
