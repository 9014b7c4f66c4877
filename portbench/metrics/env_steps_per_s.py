"""env_steps_per_s: episode ticks over the whole window (from its start to
the last chunk's done-check sync). Every slot of the batch counts: an
episode that has ended is stepped, masked, like the others, so the work
of a tick does not depend on how the seed's episodes end. The share that
began alive goes to standard error."""

import sys


def read(rec):
  if rec.get("kind") != "eval" or rec["window_s"] <= 0:
    return None
  if rec["episode_ticks"]:
    print(f"env_steps: {rec['episode_ticks']} episode ticks, "
          f"{rec['alive_ticks'] / rec['episode_ticks']!r} of them alive",
          file=sys.stderr)
  return rec["episode_ticks"] / rec["window_s"]
