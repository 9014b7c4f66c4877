"""idle_share.eval: 1 - the union of device operations' intervals over the
traced stretch of ticks."""


def read(rec):
  if rec.get("kind") != "eval" or rec.get("trace") is None:
    return None
  idle = rec["trace"].idle_share()
  return None if idle is None else 100.0 * idle
