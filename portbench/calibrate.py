"""Readings for the limits of ``correct``: over many seeds in one
process, the numbers that sound runs of the program give, and on some of
them the numbers of the control (the reference one precision below the
configuration's, in the program's place).

  python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
      --control-seeds 1,2,3 --seconds 5 [--fault <name>]

Each seed gets its own scene, weights and draws, a short window at the
cell's own load, and the check of a full run. One JSON line a seed; the
benchmark's own runs never run the control. --fault plants one of
``faults.FAULTS`` in the program for the run (the check runs unbroken).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import faults, harness


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--control-seeds", default="")
  ap.add_argument("--seconds", type=float, default=5.0)
  ap.add_argument("--fault", default=None, choices=sorted(faults.FAULTS),
                  help="plant this fault in the program")
  args = ap.parse_args(argv)
  seeds = [int(s) for s in args.seeds.split(",") if s]
  control = {int(s) for s in args.control_seeds.split(",") if s}
  bench = harness.load_benchmark()
  entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
  harness.require_cards(entry["chips"])
  harness.point_caches()
  for seed in seeds:
    t0 = time.perf_counter()
    ctx, _, _ = harness.make_context(args.workload, seed, False, bench=bench)
    undo = faults.FAULTS[args.fault](ctx) if args.fault else None
    drv = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
    drv.setup()
    rec = drv.window(args.seconds)
    drv.release()
    if undo is not None:
      undo()
    values = drv.check(control=seed in control)
    print(json.dumps({"seed": seed, "values": values,
                      "where": getattr(drv, "where", None),
                      "window_s": rec["window_s"],
                      "seconds": time.perf_counter() - t0}), flush=True)
    del drv, ctx, rec
    gc.collect()
    torch.cuda.empty_cache()
  found = harness.forbidden_loaded()
  if found:
    print(f"forbidden modules loaded: {found}", file=sys.stderr)
    return 2
  return 0


if __name__ == "__main__":
  sys.exit(main())
