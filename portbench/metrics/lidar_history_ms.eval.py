"""lidar_history_ms.eval: the temporal LiDAR buffer: the program's span
``agent.lidar_history`` inside ``agent.inputs`` (the buffered half
sweeps' realignment into the current ego frame and the older sweeps'
voxelization); the median over the window's ticks outside the traced
stretch of the span's CUDA-event time in each
(``program_spans.layer_ms``). The span's counter, the frames it
voxelized a tick, goes to standard error. Importing this file turns the
program's recorder on."""

import sys

from portbench import program_spans

program_spans.turn_on()

NAME = "agent.lidar_history"


def read(rec):
  ms = program_spans.layer_ms(rec, "eval", NAME, "lidar_history_ms")
  if ms is not None:
    counts = {getattr(s, "count", None) for s in program_spans.recorded()
              if s.name == NAME}
    print(f"lidar_history: frames a tick {sorted(counts, key=str)}",
          file=sys.stderr)
  return ms
