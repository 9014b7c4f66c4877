"""Port parity: the multi-device layer (carla_garage_tpu_torch/parallel/ and
the mesh half of eval/benchmark.py) against the JAX package's meshed runs
on the CPU.

JAX runs one controller over the 8-device virtual CPU mesh of
``tests/conftest.py``; the port runs two processes over gloo
(``parallel/launch.spawn``, a ``file://`` store under the test's
temporary directory, torch on one thread in each rank). Held here:
``_pad_for_mesh`` and each rank's ``shard_leading`` slice against JAX's
padding and ``addressable_shards``; the expert's sharded rollout (B=4,
64 ticks in chunks of 32, as ``tests/test_parallel.py``), its gathered
records against JAX's meshed records with JAX's draws replayed, and
against one process; ``run_carla_benchmark`` over two ranks (per town,
with an episode count that needs padding and the analysis files, and one
mixed-town batch) against one process; ``dryrun_multichip`` on two CPU
ranks against one; and the launcher's refusals.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.eval import benchmark as j_bench
from carla_garage_tpu.parallel import mesh as j_mesh
from carla_garage_tpu.sim.episode import rollout_chunked as j_rollout_chunked
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.eval import benchmark
from carla_garage_tpu_torch.parallel import launch, mesh, workers
from carla_garage_tpu_torch.parallel.dryrun import dryrun_multichip
from test_torch_port_carla_benchmark import compare_records
from test_torch_port_importer import write_asset_root

T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def rank_view(rank, size):
  """A rank's mesh record without a process group (slicing only)."""
  return mesh.Mesh(group=None, rank=rank, size=size,
                   device=torch.device("cpu"))


def spawn2(fn, tmp_path, *args):
  return launch.spawn(fn, 2, "gloo", "cpu", *args, tmpdir=str(tmp_path),
                      threads=1)


def test_pad_for_mesh_matches_jax():
  for n in (2, 4):
    jm = j_mesh.make_mesh(n)
    for k in (1, 3, 4, 5):
      eps, ids = list(range(k)), [f"r{i}" for i in range(k)]
      extras = ([f"x{i}" for i in range(k)], list(range(10, 10 + k)))
      want = j_bench._pad_for_mesh(jm, eps, ids, extras)
      got = benchmark._pad_for_mesh(rank_view(0, n), eps, ids, extras)
      assert got == want, (n, k, got, want)
      assert len(got[0]) % n == 0 and got[1].count(None) == (-k) % n


def test_shard_leading_matches_jax_shards():
  """Each rank's slice against the matching addressable shard of JAX's
  shard_leading on make_mesh(2); leaves of another leading size whole, as
  JAX replicates them."""
  rng = np.random.default_rng(0)
  B = 6
  tree = {"x": rng.normal(size=(B, 3)).astype(np.float32),
          "i": rng.integers(0, 9, B).astype(np.int32),
          "m": rng.uniform(size=(B, 2, 2)) > 0.5,
          "other": rng.normal(size=(4,)).astype(np.float32),
          "scalar": np.float32(3.0)}
  jm = j_mesh.make_mesh(2)
  sharded = j_mesh.shard_leading(jm, tree, B)
  for r in range(2):
    got = mesh.shard_leading(rank_view(r, 2), {k: T(v) for k, v in
                                               tree.items()}, B)
    for k, leaf in sharded.items():
      shards = sorted(leaf.addressable_shards,
                      key=lambda s: (s.index[0].start or 0)
                      if s.index else 0)
      if k in ("x", "i", "m"):
        assert len({s.index[0].start for s in shards}) == 2, k
        want = [s for s in shards if (s.index[0].start or 0) ==
                r * B // 2][0].data
      else:
        want = shards[0].data                    # replicated
      np.testing.assert_array_equal(got[k].numpy(), np.asarray(want), k)
  # [T,B,...] leaves (recorded frames) along dim 1
  f = T(rng.normal(size=(5, B, 2)).astype(np.float32))
  for r in range(2):
    got = mesh.shard_leading(rank_view(r, 2), {"f": f}, B, dim=1)["f"]
    assert torch.equal(got, f[:, r * 3:(r + 1) * 3])
  with pytest.raises(ValueError, match="does not split"):
    mesh.shard_leading(rank_view(0, 4), {"x": T(tree["x"])}, B)


def jax_expert_draws(rng, ticks, B):
  """JAX's per-tick draws of the expert on a batch without scenarios: a
  tick splits state.rng three ways (episode.py:51), the steer noise from
  the second key."""
  draws = []
  for _ in range(ticks):
    rng, r_step, _ = jax.random.split(rng, 3)
    draws.append({"steer_noise": T(jax.random.normal(r_step, (B,)))})
  return draws


def test_sharded_expert_rollout_matches_jax_meshed_records(tmp_path):
  """The expert on B=4 episodes over two ranks, 64 ticks in chunks of 32:
  the gathered records (global indices, every rank the same) against
  JAX's on a 2-device mesh with the same draws, and bit-equal to one
  process's."""
  B, ticks, chunk = 4, 64, 32
  build = dict(batch=B, seed=11, n_vehicles=2, n_walkers=1)
  jm = j_mesh.make_mesh(2)
  _, maps, lanes, scene, state = make_synthetic_batch(JCFG, **build)
  assert not scene.scenarios                   # no control-loss draws
  maps, lanes, scene, state = j_bench._shard_episode_batch(
      jm, maps, lanes, scene, state)
  assert len(scene.route.num_valid.sharding.device_set) == 2
  final = j_rollout_chunked(JCFG, maps, lanes, scene, state,
                            max_ticks=ticks, chunk=chunk)
  ids = [f"m_{i}" for i in range(B)]
  j_recs = j_bench._records(JCFG, scene, final, ids, "SynthTown")
  path = tmp_path / "rollout.pt"
  torch.save(dict(cfg=CFG, build=build, ticks=ticks, chunk=chunk,
                  draws=jax_expert_draws(state.rng, ticks, B)),
             path)
  out = spawn2(workers.rollout_records_rank, tmp_path, str(path))
  assert out[0] == out[1]
  recs = out[0]
  assert [r["index"] for r in recs] == list(range(B))
  compare_records(recs, j_recs, benchmark.aggregate(recs),
                  j_bench.aggregate(j_recs))
  assert max(r["scores"]["score_route"] for r in recs) > 0
  assert workers.rollout_records_rank(None, str(path),
                                      device="cpu") == recs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
  base = tmp_path_factory.mktemp("assets")
  r = str(base / "reference")
  write_asset_root(r)
  mp = pytest.MonkeyPatch()
  mp.setenv("CGT_TOWN_CACHE", str(base / "town_cache"))
  yield r
  mp.undo()


@pytest.mark.parametrize("single_batch", [False, True])
def test_meshed_carla_benchmark_matches_one_process(root, tmp_path,
                                                    monkeypatch,
                                                    single_batch):
  """run_carla_benchmark with scenarios over two ranks: per town (Town01's
  3 routes padded to 4, with the analysis files written by rank 0) and
  as one mixed-town batch (5 episodes padded to 6). Each rank draws the
  global batch's steer and control-loss noise and keeps its slice, so
  the gathered records equal one process's run, in the same order."""
  chunk = 16
  cfg = CFG.replace(sim=dataclasses.replace(CFG.sim, max_vehicles=16))
  kw = dict(cfg=cfg, benchmark="longest6", n_vehicles=6, n_walkers=2,
            max_ticks=chunk, seed=3, verbose=False, assets_root=root,
            single_batch=single_batch)
  if not single_batch:
    kw["analysis_dir"] = str(tmp_path / "dp")
  out = spawn2(workers.benchmark_rank, tmp_path, kw, chunk)
  assert out[0] == out[1]
  recs, g = out[0]
  monkeypatch.setattr(benchmark, "CARLA_CHUNK", chunk)
  monkeypatch.setattr(benchmark, "RECORD_CHUNK", chunk)
  if not single_batch:
    kw["analysis_dir"] = str(tmp_path / "one")
  want, want_g = benchmark.run_carla_benchmark(device="cpu", **kw)
  assert len(recs) == 5
  assert recs == want and g == want_g
  if not single_batch:
    assert sorted(os.listdir(tmp_path / "dp")) == \
        sorted(os.listdir(tmp_path / "one"))
    for name in os.listdir(tmp_path / "one"):
      assert (tmp_path / "dp" / name).read_bytes() == \
          (tmp_path / "one" / name).read_bytes(), name


def test_dryrun_multichip_two_cpu_ranks_match_one(tmp_path, capsys):
  """The dry run end to end on two gloo ranks, then on one: every stage
  draws the global batch's draws and keeps its slice, so both give the
  same PlanT loss, TransFuser++ loss (bf16, at the micro size) and
  benchmark records; ZeRO-1 halves the optimizer state per rank."""
  two = dryrun_multichip(2, backend="gloo", device="cpu",
                         tmpdir=str(tmp_path), threads=1)
  printed = capsys.readouterr().out
  assert "dryrun_multichip ok: 2 ranks, env batch 8" in printed
  assert two[0]["records"] == two[1]["records"]
  assert len(two[0]["records"]) == 8
  for k in ("plant_loss", "transfuser_loss"):
    assert np.isfinite(two[0][k]) and two[0][k] == two[1][k], k
  shard, repl = two[0]["opt_bytes_per_rank"], two[0]["opt_bytes_replicated"]
  assert sum(shard) == repl and 1.8 < repl / max(shard) <= 2.0, (shard,
                                                                  repl)
  one = dryrun_multichip(1, backend="gloo", device="cpu",
                         tmpdir=str(tmp_path), threads=1)[0]
  assert one["opt_bytes_replicated"] == repl
  assert one["opt_bytes_per_rank"] == [repl]
  assert one["records"] == two[0]["records"]
  # float32 sums over 16 rows on one rank or 8 + 8 on two
  np.testing.assert_allclose(two[0]["plant_loss"], one["plant_loss"],
                             rtol=1e-5)
  # bf16 convolutions at batch 4 a rank or 8 on one
  np.testing.assert_allclose(two[0]["transfuser_loss"],
                             one["transfuser_loss"], rtol=1e-2)


def test_launcher_refuses_and_reports(tmp_path):
  """NCCL needs a card per rank and never falls back to gloo; a rank that
  raises makes spawn raise with its error."""
  with pytest.raises(ValueError, match="gloo"):
    dryrun_multichip(2, backend="nccl", device="cuda")
  with pytest.raises(ValueError, match="gloo"):
    launch.spawn(workers.rollout_records_rank, 2, "nccl", "cpu", "x")
  with pytest.raises(Exception, match="No such file"):
    spawn2(workers.rollout_records_rank, tmp_path,
           str(tmp_path / "missing.pt"))
  assert launch.rank_device(3, "cpu") == torch.device("cpu")
