"""idle_share.train: 1 - the union of device operations' intervals over the
traced stretch of training steps."""


def read(rec):
  if rec.get("kind") != "train" or rec.get("trace") is None:
    return None
  idle = rec["trace"].idle_share()
  return None if idle is None else 100.0 * idle
