"""Port parity: the last two root scripts, ``bench_forward`` and
``merge_seed_runs`` (``carla_garage_tpu_torch/scripts/``), on the CPU.

``bench_forward`` runs at ``micro_config()`` on the CPU for both norms:
its JSON line keeps the JAX script's seven keys, and its parameter count
is the JAX model's, at the micro size and (on the meta device against
``jax.eval_shape``) at full spec. ``merge_seed_runs`` merges the committed
per-seed PlanT endpoints into the committed merged files and into what
the JAX script writes from the same inputs.
"""

import importlib.util
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.scripts import bench_forward, merge_seed_runs

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = {"norm", "batch", "bf16", "params_M", "compile_s", "ms_per_step",
        "frames_per_s"}
MICRO = ["--micro", "--batch", "2", "--iters", "1", "--no-bf16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def jax_param_count(tcfg, norm) -> int:
  """The JAX LidarCenterNet's parameter count from ``eval_shape`` (nothing
  is allocated or compiled)."""
  model = jtf.LidarCenterNet(tcfg, norm=norm)
  args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
      (1, tcfg.img_h, tcfg.img_w, 3),
      (1, tcfg.lidar_h, tcfg.lidar_w, tcfg.lidar_channels), (1, 2), (1, 6),
      (1,))]
  shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
  return sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("norm", ["gn", "bn_affine"])
def test_bench_forward_micro_on_the_cpu(norm, capsys, tmp_path):
  """The JSON line's keys and values at micro size; the gn run also
  profiles (on the CPU: host ops, no busy share) and writes its trace."""
  argv = MICRO + ["--norm", norm]
  if norm == "gn":
    argv += ["--profile", str(tmp_path / "trace")]
  assert bench_forward.main(argv, device="cpu") == 0
  lines = capsys.readouterr().out.strip().splitlines()
  rec = json.loads(lines[-1])
  assert set(rec) == KEYS
  assert rec["norm"] == norm and rec["batch"] == 2 and rec["bf16"] is False
  assert rec["params_M"] == 4.8
  assert rec["ms_per_step"] > 0 and rec["frames_per_s"] > 0
  n = bench_forward.count_params(ttf.micro_config(), norm)
  assert n == jax_param_count(jtf.micro_config(), norm) == 4_797_763
  if norm == "gn":
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("host ops" in ln for ln in lines[:-1])
    assert any("not measured" in ln for ln in lines[:-1])


def test_bench_forward_full_spec_params_and_flops():
  """Full spec on the meta device: JAX's parameter count for both norms,
  params_M 120.3, and a forward's operation count that the norm does not
  change."""
  want = 120_294_167
  for norm in ("gn", "bn_affine"):
    assert jax_param_count(jtf.TransfuserConfig(), norm) == want
    assert bench_forward.count_params(ttf.TransfuserConfig(), norm) == want
  assert round(want / 1e6, 1) == 120.3
  gn, bn = (bench_forward.forward_flops(ttf.TransfuserConfig(), n, 16)
            for n in ("gn", "bn_affine"))
  assert gn == bn > 1e12


def test_bench_forward_outputs_and_inputs_are_seeded():
  """The same seed gives the same inputs and the same output scalar; the
  bf16 run's scalar is near the float32 one's; the card is the default,
  and without one the script raises."""
  args = bench_forward.parse_args(MICRO)
  a, b = (bench_forward.run(args, "cpu")[1]["out"] for _ in range(2))
  assert a == b and math.isfinite(a)
  args16 = bench_forward.parse_args(MICRO[:-1])
  rec, extra = bench_forward.run(args16, "cpu")
  assert rec["bf16"] is True
  assert abs(extra["out"] - a) <= 0.05 * abs(a)
  rgb, lid, tp, cmd, spd = bench_forward.make_inputs(ttf.micro_config(), 2,
                                                     "cpu")
  assert 0 <= float(rgb.min()) and float(rgb.max()) < 1
  assert lid.shape == (2, 64, 64, 2) and float(tp.abs().sum()) == 0
  assert cmd.argmax(-1).tolist() == [1, 1] and float(spd.sum()) == 0
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="device='cpu'"):
      bench_forward.main(MICRO)


def load_jax_script(name):
  spec = importlib.util.spec_from_file_location(
      f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def json_close(got, want, where=""):
  """Equal structure and values, floats within 1e-12 of each other."""
  if isinstance(want, dict):
    assert set(got) == set(want), where
    for k in want:
      json_close(got[k], want[k], f"{where}/{k}")
  elif isinstance(want, list):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
      json_close(g, w, f"{where}/{i}")
  elif isinstance(want, float):
    assert abs(got - want) <= 1e-12, (where, got, want)
  else:
    assert got == want, (where, got, want)


@pytest.mark.parametrize("bench", ["longest6", "lav"])
def test_merge_seed_runs_matches_committed_and_jax(bench, tmp_path,
                                                   monkeypatch, capsys):
  """The port's merge of the committed seed files equals the committed
  merged file (its records, global record and values) and the JAX
  script's output on the same inputs, but for ``meta.reps``."""
  monkeypatch.chdir(ROOT)
  inputs = [f"results/{bench}_plant_r5_honest_seed{s}.json"
            for s in range(3)]
  out = tmp_path / "port.json"
  assert merge_seed_runs.main(inputs + ["--out", str(out)]) == 0
  assert "(3 seeds)" in capsys.readouterr().out
  got = json.loads(out.read_text())
  committed = json.loads(
      (ROOT / f"results/{bench}_plant_r5_honest.json").read_text())
  json_close(got["_checkpoint"], committed["_checkpoint"], "_checkpoint")
  json_close(got["values"], committed["values"], "values")
  assert got["labels"] == committed["labels"]
  assert {r["seed"] for r in got["_checkpoint"]["records"]} == {0, 1, 2}
  g = got["_checkpoint"]["global_record"]
  assert len(g["per_seed"]) == 3 and g["driving_score_std"] > 0

  jax_out = tmp_path / "jax.json"
  monkeypatch.setattr(sys, "argv", ["merge_seed_runs.py"] + inputs +
                      ["--out", str(jax_out)])
  load_jax_script("merge_seed_runs").main()
  want = json.loads(jax_out.read_text())
  assert got["meta"].pop("reps") == "3 seeds x reps=1 (per-seed invocations)"
  assert "DEVICE_FAULT" in want["meta"].pop("reps")
  assert got["meta"]["cmdline"].count("--seed {0,1,2}") == 1
  assert got == want
