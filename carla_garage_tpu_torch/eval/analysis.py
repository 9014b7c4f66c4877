"""Result analytics (the part of carla_garage_tpu/eval/analysis.py that
the benchmark records need).

The criteria's event log (``CriteriaState.event_*``) carries every scored
infraction's position, kind (``structs.EventKind``) and tick. The
infraction maps and replay clips of the JAX package draw with matplotlib
and are not ported.
"""

from __future__ import annotations


def events_from_criteria(cr, index: int) -> list:
  """Episode `index`'s event log as a list of {pos, kind, tick} dicts.
  Pass criteria already on the host to make no device copy per call."""
  n = int(cr.event_count[index])
  pos = cr.event_pos[index].cpu().numpy()
  kind = cr.event_kind[index].cpu().numpy()
  tick = cr.event_tick[index].cpu().numpy()
  return [{"pos": pos[i].tolist(), "kind": int(kind[i]),
           "tick": int(tick[i])} for i in range(n)]
