"""roofline.lidar_video.eval: the Video Swin LiDAR branch's bound over
its device time in the traced stretch, in %.

The bound of a forward is the frozen count of the branch's HBM bytes and
operations (``reference/vswin.lidar_video_cost`` at the sizes of the
configuration ``tfpp_vswin`` and the record's batch, 2 bytes a value) at
the card's peaks in the configuration's precision; the time is that of
every device operation between the marker kernels of the program's span
``model.lidar_video`` in each replay of the forward's CUDA graph
(``markers.span_replays_ms``). None in a run of another configuration
(its forward FLOPs differ) or without the markers. Importing this file
turns the program's recorder on."""

from portbench import harness, markers, program_spans
from portbench.reference import peaks

program_spans.turn_on()

NAME = "model.lidar_video"
CONFIG = "tfpp_vswin"


def read(rec):
  if rec.get("kind") != "eval":
    return None
  config = harness.load_config(CONFIG)
  if rec.get("flops_per_sample") != \
      config.CONFIG["forward_flops_per_sample"]:
    return None
  ms = markers.span_replays_ms(rec, NAME, "roofline.lidar_video")
  if not ms or sum(ms) <= 0:
    return None
  from portbench.reference import vswin
  m = config.CONFIG["model"]
  n_bytes, flops = vswin.lidar_video_cost(
      config.reference_configs(m)[1], rec["batch"],
      (m["lidar_h"], m["lidar_w"]))
  bound = peaks.bound_s(n_bytes, flops, rec["precision"])
  return 100.0 * bound * len(ms) / (sum(ms) * 1e-3)
