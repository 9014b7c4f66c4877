"""mfu.train: 3 times the configuration's frozen forward FLOPs per sample
(forward and backward) times the samples of the steps outside the traced
stretch, over their time (CUDA events at step entries), as a share of
the card's peak in the configuration's precision."""

from portbench.reference import peaks


def read(rec):
  if rec.get("kind") != "train" or not rec.get("flops_per_sample"):
    return None
  idx = [i for i in range(len(rec["step_ms"])) if i not in rec["traced"]]
  seconds = sum(rec["step_ms"][i] for i in idx) * 1e-3
  if seconds <= 0:
    return None
  flops = 3 * rec["flops_per_sample"] * rec["samples_per_step"] * len(idx)
  return 100.0 * flops / seconds / peaks.FLOPS[rec["precision"]]
