"""roofline.vlm.eval: SimLingo's vision tower, projector and decoder:
their bound over their device time in the traced stretch, in %.

The bound of a forward is the frozen count of their HBM bytes and
operations (``reference/simlingo.vlm_cost`` at the sizes of the
configuration ``simlingo`` and the record's batch, 2 bytes a value) at
the card's peaks in the configuration's precision; the time is that of
every device operation between the marker kernels of the program's spans
``model.vision`` and ``model.language`` in each replay of the forward's
CUDA graph (``markers.span_replays_ms``). None in a run of another
configuration (its forward FLOPs differ) or without the markers.
Importing this file turns the program's recorder on."""

from portbench import harness, markers, program_spans
from portbench.reference import peaks

program_spans.turn_on()

NAMES = ("model.vision", "model.language")
CONFIG = "simlingo"


def read(rec):
  if rec.get("kind") != "eval":
    return None
  config = harness.load_config(CONFIG)
  if rec.get("flops_per_sample") != \
      config.CONFIG["forward_flops_per_sample"]:
    return None
  spans = [markers.span_replays_ms(rec, n, "roofline.vlm") for n in NAMES]
  if not all(spans) or len(spans[0]) != len(spans[1]):
    return None
  seconds = sum(sum(ms) for ms in spans) * 1e-3
  if seconds <= 0:
    return None
  from portbench.reference import simlingo
  n_bytes, flops = simlingo.vlm_cost(
      rec["batch"], config.reference_config(config.CONFIG["model"]))
  bound = peaks.bound_s(n_bytes, flops, rec["precision"])
  return 100.0 * bound * len(spans[0]) / seconds
