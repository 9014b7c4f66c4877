"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import math
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
  return harness.load_benchmark()


def test_top_level_keys(bench):
  assert set(bench) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert 1 <= bench["run_seconds"] <= 51
  assert 1 <= len(bench["paths"]) <= 16
  for p in bench["paths"]:
    assert PATH.match(p) and not p.startswith("/") and ".." not in p
  assert len(bench["command"]) <= 32
  assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(bench):
  groups = [bench["configs"], bench["workloads"], bench["end_to_end"],
            bench["per_layer"]]
  for group in groups:
    names = [x["name"] for x in group]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
  metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
  assert len(metrics) == len(set(metrics))
  for m in bench["end_to_end"] + bench["per_layer"]:
    assert UNIT.match(m["unit"]), m
    assert m["better"] in ("lower", "higher")
  for w in bench["workloads"]:
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
  for c in bench["configs"]:
    assert all(NAME.match(k) for k in c["reduced"])
    assert 1 <= len(c["source"]) <= 200


def test_entry_keys(bench):
  for c in bench["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
  for w in bench["workloads"]:
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    pairs = [(x["config"], x["traffic"]) for x in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
  for m in bench["end_to_end"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
  assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
  layers = {m["layer"] for m in bench["per_layer"]}
  e2e = {m["name"] for m in bench["end_to_end"]}
  for m in bench["per_layer"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert m["moves"] in e2e
  assert layers


def test_every_cell_reports_enough(bench):
  for w in bench["workloads"]:
    e2e = [m["name"] for m in harness.cell_metrics(bench, w["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(bench, w["name"], True)
    # a per-layer metric's cells report the end-to-end metric it moves
    for m in harness.cell_metrics(bench, w["name"], True):
      assert m["moves"] in e2e


def test_files_found_by_name(bench):
  for c in bench["configs"]:
    assert (harness.ROOT / c["file"]).is_file()
    mod = harness.load_config(c["name"])
    assert mod.CONFIG["reduced"] == c["reduced"]
    assert mod.CONFIG["forward_flops_per_sample"] > 0
  for w in bench["workloads"]:
    traffic = harness.load_traffic(w["traffic"])
    harness.load_driver(traffic["driver"])
    assert harness.load_limits(w["name"])
  for m in bench["end_to_end"] + bench["per_layer"]:
    assert callable(harness.load_reader(m["name"]).read)


def test_files_under_paths_are_named_from_names(bench):
  for path in (harness.ROOT / p for p in bench["paths"]):
    for f in path.rglob("*"):
      if "__pycache__" in f.parts:
        continue
      rel = str(f.relative_to(harness.ROOT))
      assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_json_files_parse():
  for f in harness.PKG.rglob("*.json"):
    json.loads(f.read_text())


def test_layouts_are_the_frozen_references():
  import torch
  from portbench import weights
  for name in harness.config_names():
    mod = harness.load_config(name)
    with torch.device("meta"):
      spec = weights.spec_of(mod.reference_model(mod.CONFIG["model"]))
    assert weights.layout(name) == spec
    assert sum(math.prod(s) for _, s in spec) == mod.CONFIG["params"]
