"""roofline.fill_boxes_bev.train: B2's bound over its device time in the
traced stretch of training steps.

The bound of each call is the frozen count of its bytes and operations
(``reference/cgt/ops/bev_fill.fill_boxes_bev_cost`` on the boxes the call
packs) at the card's peaks; the time is that of every device operation
launched inside the training render's call of ``fill_boxes_bev``."""

import inspect

from portbench.reference import peaks

SPAN = ("carla_garage_tpu_torch.sensors.bev", "fill_boxes_bev")


def read(rec):
  if rec.get("kind") != "train" or rec.get("trace") is None:
    return None
  calls = rec["calls"].get(SPAN[1]) or []
  seconds, n = rec["trace"].range_device_s("portbench." + SPAN[1])
  if not calls or seconds <= 0:
    return None
  from portbench.reference.cgt.ops import bev_fill
  sig = inspect.signature(bev_fill.fill_boxes_bev)
  bound = 0.0
  for args, kw in calls:
    a = sig.bind(*args, **kw)
    a.apply_defaults()
    p = a.arguments
    boxes = bev_fill.pack_boxes(
        p["cx"], p["cy"], p["yaw"].cos(), p["yaw"].sin(), p["ex"], p["ey"],
        p["cls"], p["valid"])
    n_bytes, flops, _ = bev_fill.fill_boxes_bev_cost(boxes, p["h"], p["w"])
    bound += peaks.bound_s(n_bytes, flops, "fp32")
  return 100.0 * bound / seconds
