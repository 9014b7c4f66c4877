"""Merge per-seed benchmark runs into one multi-seed artifact (port of
scripts/merge_seed_runs.py).

A benchmark's repetitions run as separate seed-indexed ``--reps 1``
invocations of ``run_benchmarks``; this assembles the reference's
3-repetition rows (evaluate_routes_slurm.py:124-312) from their endpoint
files: the records are concatenated, each tagged with its seed, the
global record is recomputed over all of them with ``aggregate``, and the
per-seed global records and the population std of their driving scores
ride along. The output keeps the JAX script's layout (``_checkpoint``,
``values``, ``labels``, ``meta``).

  python -m carla_garage_tpu_torch.scripts.merge_seed_runs \\
      results/longest6_plant_r5_honest_seed{0,1,2}.json \\
      --out results/longest6_plant_r5_honest.json

One difference from the JAX script: its ``meta.reps`` gives a device
fault of the TPU as the reason for per-seed invocations. That fault is
not the port's, so here ``meta.reps`` only says how the runs were made.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from carla_garage_tpu_torch.eval.benchmark import aggregate


def merge(inputs: list) -> dict:
  """The merged artifact of the endpoint files `inputs`, in their order."""
  records, per_seed, seeds, metas = [], [], [], []
  for path in inputs:
    with open(path) as f:
      d = json.load(f)
    ck = d["_checkpoint"]
    meta = d.get("meta", {})
    seed = meta.get("seed", len(seeds))
    seeds.append(seed)
    metas.append(meta)
    records += [dict(r, seed=seed) for r in ck["records"]]
    per_seed.append(ck["global_record"])

  g = aggregate(records)
  g["driving_score_std"] = float(np.array(
      [p["driving_score"] for p in per_seed]).std())
  g["per_seed"] = per_seed
  m0 = metas[0]
  meta = {
      "benchmark": m0.get("benchmark"),
      "reps": f"{len(seeds)} seeds x reps=1 (per-seed invocations)",
      "n_vehicles": m0.get("n_vehicles"),
      "capacity": m0.get("capacity"),
      "scenarios": m0.get("scenarios"),
      "seeds": seeds,
      "checkpoint": m0.get("checkpoint"),
      "uncertainty_threshold": m0.get("uncertainty_threshold"),
      "cmdline": m0.get("cmdline", "").replace(
          "--seed 0", "--seed {%s}" % ",".join(map(str, seeds))),
      "inputs": list(inputs),
  }
  return {
      "_checkpoint": {"records": records, "global_record": g},
      "values": [g["driving_score"], g["route_completion"],
                 g["infraction_score"]],
      "labels": ["Avg. driving score", "Avg. route completion",
                 "Avg. infraction penalty"],
      "meta": meta,
  }


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("inputs", nargs="+")
  ap.add_argument("--out", required=True)
  args = ap.parse_args(argv)
  out = merge(args.inputs)
  with open(args.out, "w") as f:
    json.dump(out, f)
  g = out["_checkpoint"]["global_record"]
  print(f"{args.out}: DS {g['driving_score']:.1f} ± "
        f"{g['driving_score_std']:.1f} / RC {g['route_completion']:.1f} / "
        f"IS {g['infraction_score']:.2f} over {g['num_routes']} episodes "
        f"({len(out['meta']['seeds'])} seeds)")
  return 0


if __name__ == "__main__":
  sys.exit(main())
