"""roofline.raycast_boxes.eval: B1's bound over its device time in the
traced stretch.

The bound of each call is the frozen count of its bytes and operations
(``reference/cgt/ops/raycast.raycast_boxes_cost`` on the call's own
inputs) at the card's peaks (float32 outside the tensor cores); the time
is that of every device operation launched inside the sensors layer's
call of ``raycast_boxes``, so a renamed or fused replacement still
counts."""

from portbench.reference import peaks

SPAN = ("carla_garage_tpu_torch.sensors.raycast", "raycast_boxes")


def read(rec):
  if rec.get("kind") != "eval" or rec.get("trace") is None:
    return None
  calls = rec["calls"].get(SPAN[1]) or []
  seconds, n = rec["trace"].range_device_s("portbench." + SPAN[1])
  if not calls or seconds <= 0:
    return None
  from portbench.reference.cgt.ops.raycast import raycast_boxes_cost
  bound = sum(peaks.bound_s(*raycast_boxes_cost(*args, **kw)[:2], "fp32")
              for args, kw in calls)
  return 100.0 * bound / seconds
