"""One run of one cell: find its files by name, set up, measure, check
and print the result line.

The run goes: refuse without enough cards; point every cache into
``build/portbench/``; let the traffic's driver build the cell from the
seed and warm up every shape it uses (``setup_s``); measure for
``--seconds``; read the peak memory; free the program; check what the
timed path produced against the frozen reference (the numbers that
``limits/<cell>.json`` names, each against its limit); refuse if JAX or
the JAX package was loaded; then let each metric's reader take its
number from the run's record and print the line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "portbench"
# compared by whole top-level module name, so the port itself
# (carla_garage_tpu_torch) does not trip it
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "carla_garage_tpu")


class HarnessError(RuntimeError):
  """A run that cannot produce a result line (no card, a missing file, a
  forbidden module)."""


def _load_module(path: Path, name: str):
  if not path.is_file():
    raise HarnessError(f"missing {path.relative_to(ROOT)}")
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  sys.modules[name] = mod
  spec.loader.exec_module(mod)
  return mod


def _module_name(kind: str, name: str) -> str:
  return f"portbench.{kind}._" + "".join(c if c.isalnum() else "_"
                                         for c in name)


def load_benchmark(root: Path = ROOT) -> dict:
  path = root / "BENCHMARK.json"
  if not path.is_file():
    raise HarnessError(f"no BENCHMARK.json in {root}")
  return json.loads(path.read_text())


def load_json(path: Path) -> dict:
  if not path.is_file():
    raise HarnessError(f"missing {path.relative_to(ROOT)}")
  return json.loads(path.read_text())


def config_names() -> list:
  return sorted(p.stem for p in (PKG / "configs").glob("*.json"))


def load_config(name: str):
  """The configuration's builder module with its sizes as ``CONFIG``."""
  mod = _load_module(PKG / "configs" / f"{name}.py",
                     _module_name("configs", name))
  mod.CONFIG = load_json(PKG / "configs" / f"{name}.json")
  return mod


def load_traffic(name: str) -> dict:
  return load_json(PKG / "traffic" / f"{name}.json")


def load_driver(name: str):
  return _load_module(PKG / "drivers" / f"{name}.py",
                      _module_name("drivers", name))


def load_reader(metric: str):
  return _load_module(PKG / "metrics" / f"{metric}.py",
                      _module_name("metrics", metric))


def load_limits(cell: str) -> dict:
  return load_json(PKG / "limits" / f"{cell}.json")["limits"]


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
  """The metrics a run of `cell` reports: the end-to-end ones without
  trace, the per-layer ones with it; a metric with ``workloads`` only in
  those cells."""
  group = bench["per_layer"] if trace else bench["end_to_end"]
  return [m for m in group if cell in m.get("workloads", [cell])]


def sub_seeds(seed: int) -> dict:
  """Independent seeds for each use, all from --seed (any whole number)."""
  ss = np.random.SeedSequence(abs(int(seed)) + (1 << 64 if seed < 0 else 0))
  s = ss.generate_state(4, dtype=np.uint32)
  return {"scene": int(s[0] >> 1), "weights": int(s[1]), "draws": int(s[2]),
          "sample": int(s[3])}


def point_caches():
  """Every build and kernel cache at a fixed path inside the checkout."""
  BUILD.mkdir(parents=True, exist_ok=True)
  for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / sub)
  os.environ["USE_FLAX"] = "0"
  from carla_garage_tpu_torch.ops import build
  from carla_garage_tpu_torch.utils import host_build
  build.BUILD_DIR = BUILD / "kernels"
  host_build.BUILD_DIR = BUILD / "native"


def require_cards(n: int):
  import torch
  if not torch.cuda.is_available():
    raise HarnessError("torch.cuda.is_available() is False: the benchmark "
                       "measures the card and never falls back to the CPU")
  if torch.cuda.device_count() < n:
    raise HarnessError(f"the cell asks for {n} cards, "
                       f"{torch.cuda.device_count()} are visible")


def forbidden_loaded() -> list:
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN_MODULES))


def card_info(n_cards: int) -> dict:
  import torch
  info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
          "count": n_cards}
  try:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    info["power_limit_w"] = float(out.stdout.split()[0])
  except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
    info["power_limit_w"] = None
  return info


class Context:
  """What a driver gets: the cell's names, its configuration module, the
  traffic's parameters, the seeds, the device and whether this run is
  traced."""

  def __init__(self, cell: str, config, traffic: dict, seed: int,
               trace: bool, device: str = "cuda", small: bool = False):
    self.cell = cell
    self.config = config
    self.traffic = traffic
    self.seed = seed
    self.seeds = sub_seeds(seed)
    self.trace = trace
    self.device = device
    self.small = small          # the tests' tiny sizes on the CPU
    self.readers = {}           # per-layer readers, for their spans
    self.stages = []            # (name, perf_counter) as set-up goes

  def stage(self, name: str):
    """Mark the end of a part of set-up (printed on standard error)."""
    if self.device == "cuda":
      import torch
      torch.cuda.synchronize()
    self.stages.append((name, time.perf_counter()))


def make_context(cell: str, seed: int, trace: bool, device: str = "cuda",
                 small: bool = False, bench: dict | None = None,
                 traffic_override: dict | None = None,
                 entry: dict | None = None):
  """The context of a cell of BENCHMARK.json, or of `entry` (a cell's
  entry kept out of it, as the tests drive one)."""
  bench = bench or load_benchmark()
  entry = entry or next((w for w in bench["workloads"]
                         if w["name"] == cell), None)
  if entry is None:
    raise HarnessError(f"no workload {cell!r} in BENCHMARK.json")
  traffic = dict(load_traffic(entry["traffic"]), **(traffic_override or {}))
  ctx = Context(cell, load_config(entry["config"]), traffic, seed, trace,
                device, small)
  if trace:
    ctx.readers = {m["name"]: load_reader(m["name"])
                   for m in cell_metrics(bench, cell, True)}
  return ctx, entry, bench


def judge(checks: list) -> tuple:
  """(correct, failed) of the compared numbers: each within its limit; a
  number that is not finite fails."""
  failed = [c for c in checks
            if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]
  return bool(checks) and not failed, len(failed)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", small: bool = False,
             traffic_override: dict | None = None,
             check_cards: bool = True) -> dict:
  """Run one cell and return its result (the line's object). The tests
  call it with ``device="cpu"``, ``small=True`` and ``check_cards=False``;
  the command line always looks for the cards first."""
  bench = load_benchmark()
  entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
  if entry is None:
    raise HarnessError(f"no workload {cell!r} in BENCHMARK.json")
  if check_cards:
    require_cards(entry["chips"])
  point_caches()
  import torch
  ctx, entry, bench = make_context(cell, seed, trace, device, small, bench,
                                   traffic_override)
  ctx.stages.append(("imports", time.perf_counter()))
  drv = load_driver(ctx.traffic["driver"]).Driver(ctx)
  drv.setup()
  ctx.stage("warm-up")
  rec = drv.window(seconds)
  rec["setup_s"] = rec["window_start"] - t0
  prev = t0
  for name, t in ctx.stages:
    print(f"setup: {name} {t - prev:.3f} s", file=sys.stderr)
    prev = t
  if device == "cuda":
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
  else:
    peak = 0
  drv.release()
  values = drv.check()
  limits = load_limits(cell)
  missing = sorted(set(limits) - set(values))
  if missing:
    raise HarnessError(f"the check gave no {missing}")
  checks = [{"name": k, "value": values[k], "limit": v}
            for k, v in limits.items()]
  correct, n_failed = judge(checks)
  found = forbidden_loaded()
  if found:
    raise HarnessError(f"forbidden modules loaded: {found}")
  metrics = {}
  for m in cell_metrics(bench, cell, trace):
    value = load_reader(m["name"]).read(rec)
    if value is not None:
      metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  dev = card_info(entry["chips"]) if device == "cuda" else \
      {"platform": device, "kind": device, "count": 1}
  dev["memory_peak_bytes"] = int(peak)
  result = {"correct": correct, "attempted": len(checks),
            "failed": n_failed, "metrics": metrics, "device": dev}
  if trace and rec.get("trace") is not None:
    tr = rec["trace"]
    dev["busy_s"] = tr.busy_s
    dev["window_s"] = tr.window_s
    result["breakdown"] = {"device_ops": tr.top_ops(10),
                           "idle_gaps": tr.idle_by_host(10)}
  result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
  return result


def print_result(result: dict):
  for name, c in result["checks"].items():
    print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)


def main(argv, t0: float) -> int:
  import argparse
  ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  try:
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t0)
  except HarnessError as e:
    print(f"portbench: {e}", file=sys.stderr)
    return 2
  except ModuleNotFoundError as e:
    print(f"portbench: the program is not here: {e}", file=sys.stderr)
    return 2
  print_result(result)
  return 0

