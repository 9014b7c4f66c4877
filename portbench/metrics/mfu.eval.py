"""mfu.eval: the configuration's frozen forward FLOPs per sample times
the batch and the ticks outside the traced stretch (the forward runs over
the whole batch every tick), over their time, as a share of the card's
peak in the configuration's precision."""

from portbench.reference import peaks


def read(rec):
  if rec.get("kind") != "eval" or not rec.get("flops_per_sample"):
    return None
  idx = [i for i in range(len(rec["tick_ms"])) if i not in rec["traced"]]
  seconds = sum(rec["tick_ms"][i] for i in idx) * 1e-3
  if seconds <= 0:
    return None
  flops = rec["flops_per_sample"] * rec["batch"] * len(idx)
  return 100.0 * flops / seconds / peaks.FLOPS[rec["precision"]]
