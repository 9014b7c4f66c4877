"""lidar_video_ms.eval: the Video Swin LiDAR branch: the device time of
the program's span ``model.lidar_video`` (the frames' reorder, the patch
embedding and the Swin stages with their time means and the fusion's
residual into every frame) in a forward. On the card the forward replays
as a CUDA graph and the span is a pair of marker kernels in it: the
median over the traced stretch's replays of the kernels between them
(``markers.span_replays_ms``). In an eager forward (no graph) it is the
ordinary span: the median over the window's ticks outside the traced
stretch of its CUDA-event time (``program_spans.layer_ms``). Importing
this file turns the program's recorder on."""

from portbench import markers, program_spans
from portbench.common import percentile

program_spans.turn_on()

NAME = "model.lidar_video"


def read(rec):
  if rec.get("kind") != "eval":
    return None
  ms = markers.span_replays_ms(rec, NAME, "lidar_video_ms")
  if ms:
    return percentile(ms, 50)
  return program_spans.layer_ms(rec, "eval", NAME, "lidar_video_ms")
