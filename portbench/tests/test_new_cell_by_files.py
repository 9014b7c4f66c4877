"""A later change adds a cell, a traffic mix and a metric with new files
and new entries alone: in a throwaway copy of the benchmark, a PlanT cell
at another batch and a metric of its own run without an edit to any file
that was there (only BENCHMARK.json gains entries)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

NEW_METRIC = '''"""alive_ticks.eval: the episode ticks that began alive in the window."""


def read(rec):
  return rec.get("alive_ticks") if rec.get("kind") == "eval" else None
'''

RUN = '''
import json, time
from portbench import harness
r = harness.run_cell("plant.eval.b3", 5, 0.3, True, time.perf_counter(),
                     device="cpu", small=True, check_cards=False,
                     traffic_override={"chunk": 4, "check_within": 8,
                                       "check_ticks": 1, "profile_at": 1,
                                       "profile_ticks": 2})
print(json.dumps({"metrics": r["metrics"], "correct": r["correct"],
                  "file": harness.__file__}))
'''


def digest(root):
  out = {}
  for dirpath, _, files in os.walk(root):
    for f in files:
      if f.endswith(".pyc"):
        continue
      p = os.path.join(dirpath, f)
      out[os.path.relpath(p, root)] = hashlib.sha256(
          open(p, "rb").read()).hexdigest()
  return out


def test_cell_and_metric_from_new_files(tmp_path):
  shutil.copytree(harness.PKG, tmp_path / "portbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
  before = digest(tmp_path / "portbench")
  pkg = tmp_path / "portbench"
  traffic = json.loads((pkg / "traffic" / "closed_loop_b16.json").read_text())
  traffic.update(batch=3, why="three routes")
  (pkg / "traffic" / "closed_loop_b3.json").write_text(json.dumps(traffic))
  (pkg / "metrics" / "alive_ticks.eval.py").write_text(NEW_METRIC)
  shutil.copy(pkg / "limits" / "plant.eval.json",
              pkg / "limits" / "plant.eval.b3.json")
  bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
  bench["workloads"].append({"name": "plant.eval.b3", "config": "plant",
                             "traffic": "closed_loop_b3", "chips": 1,
                             "why": "three routes"})
  for m in bench["end_to_end"]:
    if "workloads" in m and "plant.eval" in m["workloads"]:
      m["workloads"].append("plant.eval.b3")
  bench["per_layer"].append({"name": "alive_ticks.eval", "unit": "ticks",
                             "better": "higher", "source": "program_counter",
                             "layer": "sim", "moves": "env_steps_per_s",
                             "workloads": ["plant.eval.b3"]})
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  after = digest(pkg)
  assert all(after[f] == h for f, h in before.items())   # nothing edited
  env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
  proc = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                        capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-3000:]
  out = json.loads(proc.stdout.strip().splitlines()[-1])
  assert out["file"].startswith(str(tmp_path))
  assert out["metrics"]["alive_ticks.eval"]["value"] > 0
  assert out["correct"]
