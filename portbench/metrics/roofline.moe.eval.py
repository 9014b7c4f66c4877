"""roofline.moe.eval: Kimi-VL's mixture-of-experts layers (router through
combine, grouped expert GEMMs included): their bound over their device
time in the traced stretch, in %.

The bound of a forward is the frozen count of the 26 layers' HBM bytes
and operations (``reference/kimi_vl.moe_cost`` at the sizes of the
configuration ``kimi_vl`` and the record's batch, 2 bytes a value:
exactly 6 routed and 2 shared experts a token, every expert's weights
read once a layer) at the card's peaks in the configuration's precision;
the time is that of every device operation between the marker kernels
of the program's span ``model.moe`` in each replay of the forward's CUDA
graph, summed over the 26 pairs (``markers.span_replays_ms``). None in a
run of another configuration (its forward FLOPs differ) or without the
markers. Importing this file turns the program's recorder on."""

from portbench import harness, markers, program_spans
from portbench.reference import peaks

program_spans.turn_on()

NAME = "model.moe"
CONFIG = "kimi_vl"


def read(rec):
  if rec.get("kind") != "eval":
    return None
  config = harness.load_config(CONFIG)
  if rec.get("flops_per_sample") != \
      config.CONFIG["forward_flops_per_sample"]:
    return None
  ms = markers.span_replays_ms(rec, NAME, "roofline.moe")
  if not ms or sum(ms) <= 0:
    return None
  from portbench.reference import kimi_vl
  n_bytes, flops = kimi_vl.moe_cost(
      rec["batch"], config.reference_config(config.CONFIG["model"]))
  bound = peaks.bound_s(n_bytes, flops, rec["precision"])
  return 100.0 * bound * len(ms) / (sum(ms) * 1e-3)
