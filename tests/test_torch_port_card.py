"""On-card tests of the port's paths, beside the kernel and graph tests of
``tests/test_torch_port_cuda.py``, whose ``cuda`` fixture skips them where
there is no card:

- card against CPU: a path on the card against the port's CPU path from
  the same weights, scenes and draws, float32 with TF32 off. The CPU path
  is what the CPU tests hold against the JAX package. Float leaves agree
  within 1e-4 abs + 1e-4 rel, ints and bools are equal; losses within
  2e-4 rel + 1e-5 abs; gradients within 1e-3 of their global norm and
  2e-2 of each tensor's largest entry (the bars of
  ``tests/test_torch_port_train.py``);
- what only the card can break: a host sync inside a tick or a train
  step, or more than one a chunk in ``rollout_chunked``; the kernels'
  launches on each path; a B1 or B2 launch that differs from its plain
  version at full width (``every_launch_checked``);
- the product entry points on the card at their CPU tests' sizes, which
  finds a tensor left on the wrong device.

This file imports no JAX. The card's tests are run by one command:

  python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py tests/test_torch_port_card.py

(--noconftest because tests/conftest.py configures JAX.)
"""

import contextlib
import dataclasses
import gzip
import json
import math
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch import bench
from carla_garage_tpu_torch.agents import sensor_agent as sa
from carla_garage_tpu_torch.agents.plant_agent import (make_plant_policy,
                                                       plant_agent_reset)
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.convert import assemble
from carla_garage_tpu_torch.convert import torch_import as ti
from carla_garage_tpu_torch.eval import benchmark
from carla_garage_tpu_torch.maps import importer
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.aim import AIMBackbone
from carla_garage_tpu_torch.models.bev_encoder import (BevEncoder,
                                                       make_projection_grid)
from carla_garage_tpu_torch.models.heads import \
    GRUWaypointsPredictorTransFuser
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig, micro_plant
from carla_garage_tpu_torch.models.video_nets import (SwinTransformer3D,
                                                      VideoResNet)
from carla_garage_tpu_torch.ops import build
from carla_garage_tpu_torch.ops.bev_fill import (fill_boxes,
                                                 fill_boxes_bev_plain,
                                                 pack_boxes)
from carla_garage_tpu_torch.ops.raycast import (raycast_boxes,
                                                raycast_boxes_plain)
from carla_garage_tpu_torch.parallel import launch, workers
from carla_garage_tpu_torch.parallel.dryrun import dryrun_multichip
from carla_garage_tpu_torch.scene_io import load_scene
from carla_garage_tpu_torch.scripts import bench_forward
from carla_garage_tpu_torch.scripts import dagger_ab as da
from carla_garage_tpu_torch.scripts import run_benchmarks as rb
from carla_garage_tpu_torch.scripts import train_plant as tp
from carla_garage_tpu_torch.scripts import train_transfuser as tf
from carla_garage_tpu_torch.sensors import bev as sensors_bev
from carla_garage_tpu_torch.sensors import raycast as sensors_raycast
from carla_garage_tpu_torch.sensors.camera import (camera_ray_grid,
                                                   render_camera)
from carla_garage_tpu_torch.sensors.lidar import (full_lidar_grid,
                                                  lidar_ray_grid)
from carla_garage_tpu_torch.sim import episode
from carla_garage_tpu_torch.sim.datagen import (SAVE_FREQ,
                                                collect_expert_frames,
                                                make_dagger_policy)
from carla_garage_tpu_torch.sim.scenarios import ScenarioType
from carla_garage_tpu_torch.sim.scene_builder import make_town_batch
from carla_garage_tpu_torch.structs import tree_items, tree_map
from carla_garage_tpu_torch.train import dataset_io, legacy_train
from carla_garage_tpu_torch.train.plant_train import (BATCH_KEYS,
                                                      build_plant_dataset,
                                                      plant_loss,
                                                      plant_trainer)
from carla_garage_tpu_torch.train.transfuser_train import (
    make_optimizer, make_train_batch, make_transfuser_train_step)
from carla_garage_tpu_torch.utils import image_io, lidar_codec
from carla_garage_tpu_torch.utils.checkpoint import (config_from_meta,
                                                     load_checkpoint,
                                                     save_checkpoint)
from port_inputs import (REGNETY_032, plant_reference_sd,
                         transfuser_reference_sd, write_asset_root)
from test_torch_port_cuda import cuda, sim_policy, sim_scene  # noqa: F401

B = 2
# the committed scene's 100 vehicle slots
CFG100 = CFG.replace(sim=dataclasses.replace(CFG.sim, max_vehicles=100))
# the micro TransFuser++ of the tick tests: a 32x128 camera, the 256x256 BEV
TICK_TCFG = dataclasses.replace(ttf.micro_config(), img_h=32, img_w=128,
                                lidar_h=256, lidar_w=256, img_anchors=(1, 4),
                                lidar_anchors=(8, 8))


# --- helpers ------------------------------------------------------------------

def committed_scene(dev, n=B):
  """The committed scene's first n episodes on dev."""
  maps, lanes, scene, state = load_scene(device="cpu")
  cut = lambda t: tree_map(lambda x: x[:n].contiguous(), t)
  return maps.to(dev), lanes.to(dev), cut(scene).to(dev), cut(state).to(dev)


def to(d, dev):
  return {k: v.to(dev) for k, v in d.items()}


def close_leaves(got, want):
  """Card against CPU: float leaves within 1e-4 abs + 1e-4 rel (float32 on
  both, TF32 off: sin, cos and reductions of two libraries), the others
  equal."""
  lg, lw = list(tree_items(got)), list(tree_items(want))
  assert lg and [k for k, _ in lg] == [k for k, _ in lw]
  for (k, x), (_, y) in zip(lg, lw):
    x, y = x.cpu(), y.cpu()
    if x.dtype.is_floating_point:
      torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4, msg=k)
    else:
      assert torch.equal(x, y), k


def close_losses(got, want, n):
  """The same float32 model on cuDNN and on the CPU's kernels."""
  assert sorted(got) == sorted(want) and len(want) == n, sorted(got)
  for k in want:
    torch.testing.assert_close(got[k].cpu(), want[k].cpu(), rtol=2e-4,
                               atol=1e-5, msg=k)


def close_grads(got, want):
  """1e-3 of the global norm and 2e-2 of a tensor's largest entry;
  attention key biases have a zero gradient in exact arithmetic."""
  assert got.keys() == want.keys()
  gmax = max(float(g.abs().max()) for g in want.values())
  norm = sum(float((g ** 2).sum()) for g in want.values()) ** 0.5
  diff = sum(float(((got[n] - g) ** 2).sum()) for n, g in want.items())
  for n, g in want.items():
    if n.endswith("key.bias"):
      assert float(got[n].abs().max()) < 1e-5 * gmax, n
      continue
    err = float((got[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
    assert err < 2e-2, (n, err)
  assert diff ** 0.5 < 1e-3 * norm, diff ** 0.5 / norm


def losses_and_grads(aux, model):
  return ({k: v.detach().cpu() for k, v in aux.items()},
          {n: p.grad.cpu() for n, p in model.named_parameters()})


def all_finite(tree):
  return all(bool(torch.isfinite(x).all()) for _, x in tree_items(tree)
             if x.dtype.is_floating_point)


def launches():
  return raycast_boxes.launches, fill_boxes.launches


@contextlib.contextmanager
def no_host_sync():
  """The body raises where it waits for the card."""
  torch.cuda.set_sync_debug_mode("error")
  try:
    yield
  finally:
    torch.cuda.set_sync_debug_mode(0)


def host_syncs(fn):
  """The places where fn waited for the card."""
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      fn()
    finally:
      torch.cuda.set_sync_debug_mode(0)
  return [f"{w.filename}:{w.lineno}" for w in caught
          if "called a synchronizing" in str(w.message)]


class LaunchCheck:
  """The launches held against their plain versions; each comparison is a
  bool on the card, read once in ``differing``."""

  def __init__(self):
    self.raycast = self.fill = 0
    self.differs = []

  def differing(self) -> int:
    return int(torch.stack(self.differs).sum()) if self.differs else 0


@pytest.fixture
def every_launch_checked(monkeypatch):
  """Runs the plain version after every B1 and B2 launch of the test (on
  card tensors), on the same inputs, and compares on the card (no host
  sync a launch): the kernels are built with -fmad=false and IEEE division
  and repeat the plain versions' fp32 operations in order, so they must
  agree bit for bit."""
  check = LaunchCheck()
  real_rc, real_bev = sensors_raycast.raycast_boxes, \
      sensors_bev.fill_boxes_bev

  def rc(o, d, b):
    t, c = real_rc(o, d, b)
    if not d.is_cuda:
      return t, c
    t_ref, c_ref = raycast_boxes_plain(o, d, b)
    check.differs.append((t != t_ref).any() | (c != c_ref).any())
    check.raycast += 1
    return t, c

  def bev(cx, cy, yaw, ex, ey, cls, valid, h=256, w=256):
    out = real_bev(cx, cy, yaw, ex, ey, cls, valid, h=h, w=w)
    if not out.is_cuda:
      return out
    boxes = pack_boxes(cx, cy, torch.cos(yaw), torch.sin(yaw), ex, ey, cls,
                       valid)
    check.differs.append((out != fill_boxes_bev_plain(boxes, h, w)).any())
    check.fill += 1
    return out

  monkeypatch.setattr(sensors_raycast, "raycast_boxes", rc)
  monkeypatch.setattr(sensors_bev, "fill_boxes_bev", bev)
  return check


@pytest.fixture
def asset_root(tmp_path, monkeypatch):
  """The CPU tests' asset root (``port_inputs.write_asset_root``), its
  towns put in a town cache of the test's own: the card's machine may
  lack h5py, so the towns are built from their layers."""
  monkeypatch.setenv("CGT_TOWN_CACHE", str(tmp_path / "town_cache"))
  root = str(tmp_path / "reference")
  for name, (arrays, ppm, off) in write_asset_root(root, h5=False).items():
    importer.write_town_cache(importer.town_from_layers(
        name, importer.layers_from_arrays(arrays), ppm, off, root), root)
  return root


def scenario_scene():
  """A B=2 scenario scene of the port's builder on the host, with a
  CONTROL_LOSS row in its last (free) slot, armed within 10 m of the route
  point 8 m ahead, for 40 ticks (the synthetic town has no annotations)."""
  _, maps, lanes, scene, state = make_town_batch(
      CFG100, "synth", batch=B, seed=1, n_vehicles=8, n_walkers=2,
      use_scenarios=True, device="cpu")
  sp = scene.scenarios
  K = sp.kind.shape[1]
  assert not bool(sp.valid[:, K - 1].any())
  last = lambda t, v: torch.cat([t[:, :K - 1], torch.full_like(t[:, K - 1:],
                                                               v)], 1)
  sp = sp.replace(
      kind=last(sp.kind, ScenarioType.CONTROL_LOSS),
      trigger_pos=torch.cat([sp.trigger_pos[:, :K - 1],
                             scene.route.points[:, 8, None]], 1),
      trigger_dist=last(sp.trigger_dist, 10.0), duration=last(sp.duration, 40),
      magnitude=last(sp.magnitude, 0.1), valid=last(sp.valid, True))
  return maps, lanes, scene.replace(scenarios=sp), state


def reduced_sizes():
  """The training tests' reduced sensor sizes: the micro model on a
  128x128 BEV and a 32x128 camera."""
  rcfg = CFG100.replace(sensor=dataclasses.replace(
      CFG100.sensor, lidar_resolution_width=128, lidar_resolution_height=128))
  tcfg = dataclasses.replace(TICK_TCFG, lidar_h=128, lidar_w=128,
                             lidar_anchors=(4, 4))
  return rcfg, tcfg


# --- the card against the CPU -------------------------------------------------

def test_every_kernel_builds(cuda):
  """Every source in ``ops/build.KERNELS`` compiles (one nvcc each, all at
  once) and loads."""
  assert set(build.build_all()) == set(build.KERNELS)
  for name in build.KERNELS:
    build.load_kernel(name)


def test_sensor_ticks_match_cpu(cuda):
  """Three sensor-on ticks of the micro TransFuser++ on the committed
  scene's first two episodes, from the same weights and GNSS, compass and
  LiDAR draws: every state leaf."""
  cam = camera_ray_grid(CFG100, scale=8)
  lf, lr = lidar_ray_grid(CFG100, 0, 16), lidar_ray_grid(CFG100, 1, 16)
  n_lidar = lf.shape[0] * lf.shape[1]
  torch.manual_seed(1)
  weights = ttf.LidarCenterNet(TICK_TCFG).state_dict()
  gen = torch.Generator().manual_seed(2)
  draws = [{"gps": torch.randn((B, 2), generator=gen),
            "compass": torch.randn((B,), generator=gen),
            "lidar": torch.rand((B, n_lidar), generator=gen)}
           for _ in range(3)]
  runs = []
  for dev in (cuda, "cpu"):
    maps, lanes, scene, st = committed_scene(dev)
    model = ttf.LidarCenterNet(TICK_TCFG).to(dev)
    model.load_state_dict(weights)
    policy = sa.make_transfuser_policy(model, None, TICK_TCFG, cam, lf, lr)
    st = st.replace(agent=sa.sensor_agent_reset(CFG100, B, n_lidar,
                                                device=dev))
    for d in draws:
      st = episode.sim_step(CFG100, maps, lanes, scene, st, policy,
                            draws=to(d, dev))
    runs.append(st)
  close_leaves(*runs)


def test_expert_datagen_matches_cpu(cuda):
  """Expert datagen of 3 frames (15 ticks) on the committed scene's first
  two episodes from the same steer-noise draws: the final state and every
  frame leaf."""
  gen = torch.Generator().manual_seed(5)
  draws = [{"steer_noise": torch.randn((B,), generator=gen)}
           for _ in range(3 * SAVE_FREQ)]
  close_leaves(*(collect_expert_frames(CFG100, *committed_scene(dev), 3,
                                       draws=[to(d, dev) for d in draws])
                 for dev in (cuda, "cpu")))


def test_train_step_matches_cpu(cuda):
  """One SGD step of the micro TransFuser++ at the reduced sensor sizes,
  two micro-batches of two episodes, from the same weights, frames (10
  expert frames recorded on the CPU) and LiDAR and speed-dropout draws:
  the loss, every aux loss and every gradient."""
  rcfg, tcfg = reduced_sizes()
  cam, lid = camera_ray_grid(rcfg, scale=8), full_lidar_grid(rcfg,
                                                             decimate=16)
  n_lidar = lid.shape[0] * lid.shape[1]
  maps, lanes, scene, state = committed_scene("cpu")
  _, frames = collect_expert_frames(rcfg, maps, lanes, scene, state, 10,
                                    generator=torch.Generator().manual_seed(3))
  torch.manual_seed(1)
  weights = ttf.LidarCenterNet(tcfg).state_dict()
  gen = torch.Generator().manual_seed(4)
  f_idx = [0, 1]
  draws = [{"lidar": torch.rand((B, n_lidar), generator=gen),
            "speed_drop": torch.rand((B,), generator=gen) < 0.15}
           for _ in f_idx]
  runs = []
  for dev in (cuda, "cpu"):
    m = ttf.LidarCenterNet(tcfg).to(dev)
    m.load_state_dict(weights)
    step, _, _ = make_transfuser_train_step(
        rcfg, tcfg, m, torch.optim.SGD(m.parameters(), lr=1.0), maps.to(dev),
        scene.to(dev), frames.to(dev), cam, lid)
    runs.append(losses_and_grads(
        step(f_idx, draws=[to(d, dev) for d in draws]), m))
  (aux_g, g_g), (aux_c, g_c) = runs
  close_losses(aux_g, aux_c, 13)
  close_grads(g_g, g_c)


@pytest.mark.parametrize("town", ["synth", "Town01"])
def test_expert_ticks_with_scenarios_match_cpu(cuda, town, request):
  """60 expert ticks with scenarios at B=2 from the same steer-noise and
  control-loss draws, every state leaf: on the port's synthetic town with
  a CONTROL_LOSS row just ahead of the ego, which must fire, and on the
  imported Town01 of the CPU tests' asset root."""
  if town == "synth":
    maps, lanes, scene, state = scenario_scene()
  else:
    _, maps, lanes, scene, state = make_town_batch(
        CFG100, town, batch=B, seed=1, n_vehicles=8, n_walkers=2,
        min_route_m=90.0, max_route_m=200.0, use_scenarios=True,
        assets_root=request.getfixturevalue("asset_root"), device="cpu")
  K = scene.scenarios.kind.shape[1]
  gen = torch.Generator().manual_seed(6)
  draws = [{"steer_noise": torch.randn((B,), generator=gen),
            "control_loss": torch.randn((B, K), generator=gen)}
           for _ in range(60)]
  runs = []
  for dev in (cuda, "cpu"):
    m, ln, sc, st = (x.to(dev) for x in (maps, lanes, scene, state))
    for d in draws:
      st = episode.sim_step(CFG100, m, ln, sc, st, draws=to(d, dev))
    runs.append(st)
  close_leaves(*runs)
  if town == "synth":
    assert int(runs[1].scenario.ticks_active[:, K - 1].min()) > 0


def test_plant_ticks_and_train_step_match_cpu(cuda):
  """20 ticks of the micro PlanT policy (direct, creep) on the scenario
  scene from the same weights and control-loss draws, every state leaf;
  then one PlanT loss and backward at batch 32 (30 expert frames recorded
  on the CPU): the loss, every aux loss and every gradient."""
  maps, lanes, scene, state = scenario_scene()
  K = scene.scenarios.kind.shape[1]
  pcfg = micro_plant()
  torch.manual_seed(7)
  weights = PlanT(pcfg).state_dict()
  gen = torch.Generator().manual_seed(8)
  draws = [{"control_loss": torch.randn((B, K), generator=gen)}
           for _ in range(20)]
  runs = []
  for dev in (cuda, "cpu"):
    m = PlanT(pcfg).to(dev)
    m.load_state_dict(weights)
    policy = make_plant_policy(m, None, pcfg, direct=True, creep=True)
    mp, ln, sc, st = (x.to(dev) for x in (maps, lanes, scene, state))
    st = st.replace(agent=plant_agent_reset(CFG100, B, device=dev))
    for d in draws:
      st = episode.sim_step(CFG100, mp, ln, sc, st, policy, draws=to(d, dev))
    runs.append(st)
  close_leaves(*runs)

  _, frames = collect_expert_frames(CFG100, maps, lanes, scene, state, 30,
                                    generator=torch.Generator().manual_seed(9))
  ds = build_plant_dataset(CFG100, pcfg, frames, scene)
  assert len(ds) >= 32, len(ds)
  batch = {k: getattr(ds, k)[:32] for k in BATCH_KEYS
           if getattr(ds, k) is not None}
  runs = []
  for dev in (cuda, "cpu"):
    m = PlanT(pcfg).to(dev)
    m.load_state_dict(weights)
    loss, aux = plant_loss(m, to(batch, dev))
    loss.backward()
    runs.append(losses_and_grads(aux, m))
  (aux_g, g_g), (aux_c, g_c) = runs
  close_losses(aux_g, aux_c, 5)
  close_grads(g_g, g_c)


def same_export(card_root, cpu_root):
  """Two exported directories: the same files; JSON floats within 1e-5;
  semantic and BEV PNGs equal; depths within 1e-4; .lzc points within
  1e-5 m plus one quantum; JPEGs within the CPU test's bound
  (tests/test_torch_port_legacy_train.py: 3 levels, 0.5 on average)."""
  def files(d):
    return sorted(os.path.relpath(os.path.join(a, f), d)
                  for a, _, fs in os.walk(d) for f in fs)

  def json_close(got, want, where):
    if isinstance(want, dict):
      assert set(got) == set(want), where
      for k in want:
        json_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
      assert len(got) == len(want), where
      for i, (g, w) in enumerate(zip(got, want)):
        json_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
      assert abs(got - want) <= 1e-5 + 1e-5 * abs(want), (where, got, want)
    else:
      assert got == want, (where, got, want)

  names = files(card_root)
  assert names and names == files(cpu_root)
  for name in names:
    a, b = os.path.join(card_root, name), os.path.join(cpu_root, name)
    kind = name.split(os.sep)[1]
    if name.endswith(".json.gz"):
      with gzip.open(a, "rt") as fa, gzip.open(b, "rt") as fb:
        json_close(json.load(fa), json.load(fb), name)
    elif kind == "rgb":
      d = np.abs(image_io.read_jpeg(a).astype(np.int16) -
                 image_io.read_jpeg(b).astype(np.int16))
      assert d.max() <= 3 and d.mean() <= 0.5, (name, d.max(), d.mean())
    elif kind == "depth":
      code = lambda p: image_io.read_png(p).astype(np.int64) @ np.array(
          [1, 256, 65536])
      da_, db_ = (code(p) * (85.0 / (256 ** 3 - 1)) for p in (a, b))
      np.testing.assert_allclose(da_, db_, rtol=1e-4, atol=1e-4,
                                 err_msg=name)
    elif name.endswith(".png"):
      assert np.array_equal(image_io.read_png(a), image_io.read_png(b)), name
    else:
      pa, pb = (lidar_codec.decompress(open(p, "rb").read()) for p in (a, b))
      assert pa.shape == pb.shape, name
      if len(pa):
        assert float(np.abs(pa - pb).max()) <= \
            1e-5 + lidar_codec.DEFAULT_SCALE, name


def test_export_matches_cpu_and_trains_on_the_card(cuda, tmp_path,
                                                   every_launch_checked):
  """``export_reference_layout`` of 16 expert frames at B=2 (a 32x128
  camera, the full sweep decimated 16x) on the card and on the CPU from
  the same draws: the same files (``same_export``), 3 B1 and 1 B2 launches
  a frame, each equal to its plain version. The frames through
  ``save_frames`` / ``load_frames`` on the card bit for bit; then two
  steps of ``train_transfuser_from_disk`` on the card's export: finite
  losses, no kernel launch."""
  F = 16
  maps, lanes, scene, state = committed_scene("cpu")
  _, frames = collect_expert_frames(CFG100, maps, lanes, scene, state, F,
                                    generator=torch.Generator().manual_seed(3))
  cam, lid = camera_ray_grid(CFG100, scale=8), full_lidar_grid(CFG100,
                                                               decimate=16)
  g = torch.Generator().manual_seed(4)
  n_rays = lid.shape[0] * lid.shape[1]
  u_render, u_points = (torch.rand((B, n_rays), generator=g) for _ in "ab")
  before = launches()
  for dev in (cuda, "cpu"):
    legacy_train.export_reference_layout(
        str(tmp_path / str(dev)), CFG100, maps.to(dev), scene.to(dev),
        frames.to(dev), cam, lid, uniform_render=u_render.to(dev),
        uniform_points=u_points.to(dev))
  n = tuple(b - a for a, b in zip(before, launches()))
  check = every_launch_checked
  assert n == (3 * F, F) and (check.raycast, check.fill) == n
  assert check.differing() == 0
  same_export(str(tmp_path / str(cuda)), str(tmp_path / "cpu"))

  on_card = frames.to(cuda)
  dataset_io.save_frames(on_card, str(tmp_path / "frames.npz"))
  back = dataset_io.load_frames(str(tmp_path / "frames.npz"))
  for (k, x), (_, y) in zip(tree_items(on_card), tree_items(back)):
    assert x.device == y.device and x.dtype == y.dtype and torch.equal(x, y), k

  before = launches()
  model, hist = legacy_train.train_transfuser_from_disk(
      str(tmp_path / str(cuda)), CFG100, TICK_TCFG, steps=2, batch_size=4,
      log_every=1, device=cuda)
  assert launches() == before
  assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)
  assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def _model_inputs(keys, rng):
  f32 = lambda a: torch.tensor(a, dtype=torch.float32)
  draw = {"rgb": lambda: rng.uniform(0, 1, (B, 3, 256, 1024)),
          "bev": lambda: rng.integers(0, 6, (B, 2, 64, 64)) / 5.0,
          "seq": lambda: rng.integers(0, 6, (B, 2, 4, 256, 256)) / 5.0,
          "z": lambda: rng.normal(size=(B, 64)),
          "tp": lambda: rng.normal(0, 10, (B, 2))}
  return tuple(f32(draw[k]()) for k in keys)


MODELS = {
    "AIMBackbone": (AIMBackbone, ("rgb",)),
    "BevEncoder": (lambda: BevEncoder(projection=make_projection_grid()),
                   ("rgb", "bev")),
    "VideoResNet": (VideoResNet, ("seq",)),
    "SwinTransformer3D": (SwinTransformer3D, ("seq",)),
    "GRUWaypointsPredictorTransFuser": (
        lambda: GRUWaypointsPredictorTransFuser(8), ("z", "tp")),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_other_models_match_cpu(cuda, name):
  """The models no closed-loop policy builds, at full width with seeded
  weights (a 4-frame 256x256 LiDAR sequence for the video nets), float32
  at B=2: every output."""
  make, keys = MODELS[name]
  x = _model_inputs(keys, np.random.default_rng(28))
  torch.manual_seed(0)
  m = make().eval()
  with torch.no_grad():
    want = m(*x)
    got = m.to(cuda)(*(t.to(cuda) for t in x))
  close_leaves(got, want)


@pytest.mark.parametrize("kind", ["transfuser", "plant"])
def test_converted_models_match_cpu(cuda, kind, tmp_path):
  """Reference-layout weights drawn from a numpy seed, float32 at B=2,
  every output: member 0 of a TransFuser++ ensemble directory
  (``config.pickle`` with the ground-plane LiDAR channel, regnety_032
  branches in timm's layout, BatchNorms folded by
  ``load_ensemble_directory``) and ``PlanTConfig()`` through
  ``convert_plant``."""
  rng = np.random.default_rng(29)
  f32 = lambda a: torch.tensor(a, dtype=torch.float32)
  if kind == "transfuser":
    attrs = {"use_ground_plane": True}
    c = assemble.transfuser_config_from_reference(attrs)
    with open(tmp_path / "config.pickle", "wb") as f:
      pickle.dump(attrs, f)
    torch.save(transfuser_reference_sd(c, seed=30, spec=REGNETY_032),
               tmp_path / "model_0030.pth")
    c, (sd,) = assemble.load_ensemble_directory(str(tmp_path))
    model = ttf.LidarCenterNet(c, norm="bn_affine")
    x = (f32(rng.uniform(0, 255, (B, c.img_h, c.img_w, 3))),
         f32(rng.integers(0, 6, (B, c.lidar_h, c.lidar_w,
                                 c.lidar_channels)) / 5.0),
         f32(rng.normal(0, 10, (B, 2))), f32(np.eye(6)[[1, 3]]),
         f32(rng.uniform(0, 8, B)))
  else:
    c = PlanTConfig()
    sd = ti.convert_plant(plant_reference_sd(c, seed=30), c.n_layers)
    model = PlanT(c)
    x = (f32(rng.normal(0, 5, (B, c.max_objects, 7))),
         torch.tensor(rng.integers(0, 4, (B, c.max_objects)),
                      dtype=torch.int32),
         f32(rng.normal(0, 10, (B, c.num_route_points, 2))), f32([0, 1]),
         f32([1, 0]), f32([0, 1]), f32(rng.uniform(0, 8, B)))
  model.load_state_dict(sd, strict=True)
  model.eval()
  with torch.no_grad():
    want = model(*x)
    got = model.to(cuda)(*(t.to(cuda) for t in x))
  close_leaves(got, want)


def test_bench_forward_micro_matches_cpu(cuda):
  """``bench_forward``'s micro forward (float32, B=2) from the same seed
  and weights: its output's sum within 1e-4 relative."""
  args = bench_forward.parse_args(["--micro", "--no-bf16", "--batch", "2",
                                   "--iters", "1"])
  on_card = bench_forward.run(args, str(cuda))[1]["out"]
  on_cpu = bench_forward.run(args, "cpu")[1]["out"]
  assert math.isfinite(on_card)
  assert abs(on_card - on_cpu) <= 1e-4 * abs(on_cpu), (on_card, on_cpu)


class StopSignAhead(torch.nn.Module):
  """`model` with a class-3 (stop sign) peak of logit +20 added to its
  CenterNet heatmap 1 m ahead of the ego, where the CPU test's scripted
  model places one: seeded random weights detect none."""

  def __init__(self, model, sensor):
    super().__init__()
    self.model, self.sensor = model, sensor

  def forward(self, *args):
    out = self.model(*args)
    heat = out["pred_bb"]["heatmap"]                 # [B,h,w,C] logits
    s = self.sensor
    cy = int(-s.min_y * heat.shape[1] / (s.max_y - s.min_y))
    cx = int((1.0 - s.min_x) * heat.shape[2] / (s.max_x - s.min_x))
    peak = torch.zeros_like(heat)
    peak[:, cy, cx, 3] = 20.0
    return dict(out, pred_bb=dict(out["pred_bb"], heatmap=heat + peak))


def test_stop_control_brakes_for_a_stop_sign(cuda, monkeypatch):
  """The full-width bf16 TransFuser++ with ``stop_control`` on the
  committed scene: after 3 ticks (the egos start at rest), a stop sign
  1 m ahead is added to the heatmap; over the next 4 ticks every moving
  ego brakes for it and every ego tracks the box or has cleared it, and
  the last tick's braking egos hold brake 1 and throttle 0. Then
  ``topk_decode`` on that tick's CenterNet outputs, card against CPU:
  ints equal, floats within 1e-5."""
  maps, lanes, scene, state = committed_scene(cuda, n=16)
  tcfg = ttf.TransfuserConfig()
  cam = camera_ray_grid(CFG100)
  lf, lr = lidar_ray_grid(CFG100, half=0), lidar_ray_grid(CFG100, half=1)
  torch.manual_seed(0)
  model = ttf.LidarCenterNet(tcfg).to(cuda)
  make = lambda m: sa.make_transfuser_policy(m, None, tcfg, cam, lf, lr,
                                             bf16=True, direct=True,
                                             stop_control=True)
  st = state.replace(agent=sa.sensor_agent_reset(
      CFG100, 16, lf.shape[0] * lf.shape[1], device=cuda))
  gen = torch.Generator(device=cuda).manual_seed(12)
  st = episode.rollout(CFG100, maps, lanes, scene, st, 3, make(model),
                       generator=gen)
  speed0 = st.ego.speed.clone()
  must_stop, topk_in = [], []
  real_stop, real_topk = sa._stop_controller, sa.topk_decode

  def stop(*a):
    out = real_stop(*a)
    must_stop.append(out[3])
    return out

  def topk(preds, **kw):
    topk_in[:] = [({k: v.clone() for k, v in preds.items()}, kw)]
    return real_topk(preds, **kw)

  monkeypatch.setattr(sa, "_stop_controller", stop)
  monkeypatch.setattr(sa, "topk_decode", topk)
  st = episode.rollout(CFG100, maps, lanes, scene, st, 4,
                       make(StopSignAhead(model, CFG100.sensor)),
                       generator=gen)
  ctl, ag = st.agent.prev_control, st.agent
  braked, moving = torch.stack(must_stop).any(0), speed0 > 0.01
  last = must_stop[-1]
  assert len(must_stop) == 4 and bool(moving.any()), speed0
  assert bool(braked[moving].all())
  assert bool((ag.stop_box_valid | (ag.clear_stop > 0)).all())
  assert bool((ctl[last, 2] == 1.0).all() and (ctl[last, 1] == 0.0).all())

  preds, kw = topk_in[0]
  got = real_topk(preds, **kw)
  want = real_topk({k: v.cpu() for k, v in preds.items()}, **kw)
  for k, v in want.items():
    if v.dtype.is_floating_point:
      torch.testing.assert_close(got[k].cpu(), v, rtol=1e-5, atol=1e-5, msg=k)
    else:
      assert torch.equal(got[k].cpu(), v), k


def test_jpeg_artifacts_match_cpu(cuda):
  """``jpeg_artifacts`` at quality 95 on the committed scene's full-width
  camera frames: under 1e-3 of the values off by more than 1e-4, none by
  0.05 (a DCT coefficient that rounds the other way at a .5 boundary
  moves its block by up to about 0.02)."""
  maps, lanes, scene, state = committed_scene(cuda)
  rgb = render_camera(CFG100, maps, scene, state,
                      camera_ray_grid(CFG100))["rgb"]
  d = (sa.jpeg_artifacts(rgb, quality=95).cpu() -
       sa.jpeg_artifacts(rgb.cpu(), quality=95)).abs()
  assert float((d > 1e-4).float().mean()) < 1e-3 and float(d.max()) < 0.05


@pytest.mark.parametrize("name", ["transfuser", "plant"])
def test_checkpoint_round_trip_on_the_card(cuda, name, tmp_path):
  """``TransfuserConfig()`` and the PlanT recipe's config saved from the
  card and loaded into a fresh model there: the config back from the
  meta, equal and hashable; the state dicts bit-equal; one forward
  equal."""
  g = torch.Generator(device=cuda).manual_seed(0)
  rand = lambda *s: torch.rand(s, generator=g, device=cuda)
  if name == "transfuser":
    c, cls = ttf.TransfuserConfig(), ttf.LidarCenterNet
    x = (rand(B, c.img_h, c.img_w, 3),
         rand(B, c.lidar_h, c.lidar_w, c.lidar_channels), rand(B, 2) * 20,
         torch.eye(6, device=cuda)[:B], rand(B) * 8)
  else:
    c, cls = tp.plant_config(), PlanT
    x = (rand(B, c.max_objects, 7) * 10,
         torch.randint(0, 4, (B, c.max_objects), generator=g, device=cuda,
                       dtype=torch.int32),
         rand(B, c.num_route_points, 2) * 30, rand(B).round(),
         rand(B).round(), rand(B).round(), rand(B) * 8)
  torch.manual_seed(0)
  model = cls(c).to(cuda).eval()
  path = str(tmp_path / name)
  save_checkpoint(path, model, meta={"model": name,
                                     "config": dataclasses.asdict(c)})
  back = config_from_meta(load_checkpoint(path, meta_only=True)[1])
  assert back == c and hash(back) == hash(c)
  torch.manual_seed(1)
  fresh = cls(back).to(cuda).eval()
  load_checkpoint(path, fresh)
  sd, sd2 = model.state_dict(), fresh.state_dict()
  assert sd.keys() == sd2.keys() and all(torch.equal(sd[k], sd2[k])
                                         for k in sd)
  with torch.no_grad():
    pairs = list(zip(tree_items(model(*x)), tree_items(fresh(*x))))
  assert pairs and all(torch.equal(a, b) for (_, a), (_, b) in pairs)


def dp_payload(cuda, path):
  """The micro TransFuser++ step at the reduced sensor sizes on the
  committed scene's first 4 episodes, saved for
  ``workers.transfuser_step_rank``: 10 expert frames recorded on the
  card, vehicles placed around three egos, episode 3 done at the step's
  frames. Returns the (sample-weight sum, CenterNet boxes) of each half of
  the batch, per micro-batch."""
  n, f_idx = 4, [1, 3]
  rcfg, tcfg = reduced_sizes()
  cam, lid = camera_ray_grid(rcfg, scale=8), full_lidar_grid(rcfg,
                                                             decimate=16)
  maps, lanes, scene, state = committed_scene(cuda, n=n)
  _, frames = collect_expert_frames(
      rcfg, maps, lanes, scene, state, 10,
      generator=torch.Generator(device=cuda).manual_seed(3))
  # two vehicles around the egos of episodes 0 and 1, one around episode
  # 2's, in every frame (a label needs 8 points of the decimated sweep)
  fw = frames.ego_yaw
  c, s = torch.cos(fw), torch.sin(fw)
  vp, vy = frames.veh_pos.clone(), frames.veh_yaw.clone()
  ve, vv = frames.veh_extent.clone(), frames.veh_valid.clone()
  for v, (dx, dy, dyaw, eps) in enumerate([(9.0, 0.5, 0.0, (0, 1, 2)),
                                           (6.0, -7.0, 1.4, (0, 1))]):
    for b in eps:
      vp[:, b, v] = frames.ego_pos[:, b] + torch.stack(
          [c[:, b] * dx - s[:, b] * dy, s[:, b] * dx + c[:, b] * dy], -1)
      vy[:, b, v] = fw[:, b] + dyaw
      ve[:, b, v] = torch.tensor([2.3, 0.95], device=cuda)
      vv[:, b, v] = True
  alive = frames.alive.clone()
  alive[f_idx, n - 1] = False
  frames = frames.replace(veh_pos=vp, veh_yaw=vy, veh_extent=ve,
                          veh_valid=vv, alive=alive)
  gen = torch.Generator().manual_seed(4)
  draws = [{"lidar": torch.rand((n, lid.shape[0] * lid.shape[1]),
                                generator=gen),
            "speed_drop": torch.rand((n,), generator=gen) < 0.15}
           for _ in f_idx]
  halves = []
  for f, d in zip(f_idx, draws):
    b = make_train_batch(rcfg, tcfg, maps, scene, frames, f,
                         torch.as_tensor(cam, device=cuda),
                         torch.as_tensor(lid, device=cuda).reshape(-1, 3),
                         to(d, cuda))
    sw = b["sample_w"]
    boxes = (b["centernet"]["mask"] & (sw[:, None] > 0)).sum(1)
    halves.append([(float(sw[h:h + 2].sum()), int(boxes[h:h + 2].sum()))
                   for h in (0, 2)])
  torch.manual_seed(1)
  torch.save(dict(cfg=rcfg, tcfg=tcfg,
                  state_dict=ttf.LidarCenterNet(tcfg).state_dict(),
                  maps=maps.to("cpu"), scene=scene.to("cpu"),
                  frames=frames.to("cpu"), camera_grid=cam, lidar_grid=lid,
                  f_idx=f_idx, draws=draws,
                  runs=[dict(optimizer="sgd", lr=1.0)]), path)
  return halves


def test_two_gloo_ranks_match_one_process(cuda, tmp_path):
  """The micro TransFuser++ step (B=4, float32, TF32 off) on two ranks
  sharing the card over gloo (NCCL takes one rank a card) against one
  process on the card, with shards of different sample weights and box
  counts: every aux loss within 1e-4 relative (cuDNN picks its algorithms
  by batch size), the all-reduced gradients within 1e-4 of their norm,
  both ranks equal."""
  path = str(tmp_path / "micro.pt")
  halves = dp_payload(cuda, path)
  assert all(a[0] != b[0] for a, b in halves)
  assert any(a[1] != b[1] for a, b in halves)
  r0, r1 = (r[0] for r in launch.spawn(workers.transfuser_step_rank, 2,
                                       "gloo", str(cuda), path,
                                       tmpdir=str(tmp_path)))
  one = tree_map(lambda x: x.cpu(), workers.transfuser_step_rank(
      None, path, device=cuda)[0])
  for k, v in one["aux"].items():
    assert torch.equal(r0["aux"][k], r1["aux"][k]), k
    assert float((r0["aux"][k] - v).abs() / v.abs().clamp(min=1e-6)) < 1e-4, k
  g0, g1, want = r0["grads"], r1["grads"], one["grads"]
  assert g0.keys() == g1.keys() == want.keys()
  assert all(torch.equal(g0[n], g1[n]) for n in g0)
  norm = sum(float((g.double() ** 2).sum()) for g in want.values()) ** 0.5
  err = sum(float(((g0[n].double() - g.double()) ** 2).sum())
            for n, g in want.items()) ** 0.5
  assert err < 1e-4 * norm, err / norm


def test_dryrun_multichip_over_nccl(cuda, tmp_path):
  """``dryrun_multichip(1)`` over NCCL: a sharded expert ``sim_step``, a
  data-parallel PlanT step, a data-parallel TransFuser++ step with ZeRO-1
  AdamW and the sharded benchmark, on one rank."""
  r, = dryrun_multichip(1, tmpdir=str(tmp_path))
  assert r["opt_bytes_per_rank"] == [r["opt_bytes_replicated"]]
  assert math.isfinite(r["plant_loss"]) and math.isfinite(r["transfuser_loss"])
  assert len(r["records"]) == r["env_batch"]


# --- what only the card can break -----------------------------------------

@pytest.mark.parametrize("kind", ["expert", "plant", "tfpp", "tfpp_dagger"])
def test_tick_syncs_once_a_chunk(cuda, kind):
  """After two ticks (the graphs' captures), a closed-loop tick at the
  tests' small sizes makes no host sync and launches B1 twice with the
  sensor policy (driving, or driving for DAgger with the expert's carry)
  and never otherwise; ``rollout_chunked`` over two chunks of 4 ticks
  waits for the card once a chunk, in its done check."""
  maps, lanes, scene, state = sim_scene(cuda)
  policy, state = sim_policy(kind.split("_")[0], state, cuda)
  if kind == "tfpp_dagger":
    policy = make_dagger_policy(policy)
  gen = torch.Generator(device=cuda).manual_seed(0)
  tick = lambda st: episode.sim_step(CFG, maps, lanes, scene, st, policy,
                                     generator=gen)
  state = tick(tick(state))
  torch.cuda.synchronize()
  b1, b2 = launches()
  with no_host_sync():
    state = tick(state)
  assert launches() == (b1 + (2 if kind.startswith("tfpp") else 0), b2)
  syncs = host_syncs(lambda: episode.rollout_chunked(
      CFG, maps, lanes, scene, state, 8, chunk=4, policy=policy,
      generator=gen))
  assert len(syncs) == 2 and all("episode.py" in s for s in syncs), syncs


@pytest.mark.parametrize("kind", ["tfpp", "plant"])
def test_train_step_makes_no_host_sync(cuda, kind):
  """After a warm-up step, training at the tests' small sizes makes no
  host sync: a TransFuser++ step (the training script's recipe in bf16:
  AdamW, clip 1.0, the multistep schedule; two micro-batches of two
  episodes at the reduced sensor sizes) launches B1 twice and B2 once a
  micro-batch; an epoch's PlanT steps in a row (``plant_trainer``, batch
  8), an epoch's first step included, launch neither."""
  maps, lanes, scene, state = committed_scene(cuda)
  gen = torch.Generator(device=cuda).manual_seed(2)
  if kind == "tfpp":
    rcfg, tcfg = reduced_sizes()
    _, frames = collect_expert_frames(rcfg, maps, lanes, scene, state, 10,
                                      generator=gen)
    model = ttf.LidarCenterNet(tcfg).to(cuda)
    opt, sched = make_optimizer(model, lr=3e-4, steps=3,
                                schedule="multistep")
    step, _, wp_valid = make_transfuser_train_step(
        rcfg, tcfg, model, opt, maps, scene, frames,
        camera_ray_grid(rcfg, scale=8), full_lidar_grid(rcfg, decimate=16),
        bf16=True, clip_norm=1.0, scheduler=sched)
    usable = torch.nonzero(wp_valid.any(-1)).flatten().tolist()
    assert len(usable) >= 2, usable
    run, want = lambda: step(usable[:2], generator=gen), (4, 2)
  else:
    _, frames = collect_expert_frames(CFG100, maps, lanes, scene, state, 30,
                                      generator=gen)
    ds = build_plant_dataset(CFG100, micro_plant(), frames, scene)
    per_epoch = (len(ds) - int(0.1 * len(ds))) // 8
    assert per_epoch >= 1, len(ds)
    tr = plant_trainer(CFG100, micro_plant(), ds, 2 * per_epoch,
                       batch_size=8, estimate_weights=True)
    run, want = lambda: [tr.step() for _ in range(per_epoch)], (0, 0)
  run()
  torch.cuda.synchronize()
  before = launches()
  with no_host_sync():
    run()
  assert tuple(b - a for a, b in zip(before, launches())) == want


@pytest.mark.parametrize("path", ["sensor_ticks", "train_step"])
def test_every_launch_matches_plain_at_full_width(cuda, path,
                                                  every_launch_checked):
  """``TransfuserConfig()`` in bf16 on the committed scene's 16 episodes:
  three sensor-on ticks (the 1024x256 camera, 29,952-ray LiDAR half
  sweeps), or one training step of two micro-batches on 12 expert frames
  (the full 59,904-ray sweep, the BEV boxes); every B1 and B2 launch equal
  to its plain version, the state or the losses finite."""
  maps, lanes, scene, state = committed_scene(cuda, n=16)
  tcfg = ttf.TransfuserConfig()
  torch.manual_seed(0)
  model = ttf.LidarCenterNet(tcfg).to(cuda)
  gen = torch.Generator(device=cuda).manual_seed(0)
  if path == "sensor_ticks":
    lf, lr = lidar_ray_grid(CFG100, half=0), lidar_ray_grid(CFG100, half=1)
    policy = sa.make_transfuser_policy(
        model, None, tcfg, camera_ray_grid(CFG100), lf, lr, direct=True,
        uncertainty_weight=True, bf16=True)
    st = state.replace(agent=sa.sensor_agent_reset(
        CFG100, 16, lf.shape[0] * lf.shape[1], device=cuda))
    out = episode.rollout(CFG100, maps, lanes, scene, st, 3, policy,
                          generator=gen)
    want = (6, 0)
  else:
    _, frames = collect_expert_frames(CFG100, maps, lanes, scene, state, 12,
                                      generator=gen)
    opt, sched = make_optimizer(model, lr=3e-4, steps=3,
                                schedule="multistep")
    step, _, wp_valid = make_transfuser_train_step(
        CFG100, tcfg, model, opt, maps, scene, frames,
        camera_ray_grid(CFG100), full_lidar_grid(CFG100), bf16=True,
        clip_norm=1.0, scheduler=sched)
    usable = torch.nonzero(wp_valid.any(-1)).flatten().tolist()
    assert len(usable) >= 2, usable
    out = step(usable[:2], generator=gen)
    want = (4, 2)
  check = every_launch_checked
  assert (check.raycast, check.fill) == want
  assert check.differing() == 0
  assert all_finite(out)


# --- the product entry points on the card ------------------------------------

def _micro_checkpoints(path):
  """The micro TransFuser++ and the micro PlanT saved as the port's
  checkpoints, seeded."""
  torch.manual_seed(0)
  save_checkpoint(str(path / "tf"), ttf.LidarCenterNet(TICK_TCFG),
                  meta={"model": "transfuser",
                        "config": dataclasses.asdict(TICK_TCFG)})
  save_checkpoint(str(path / "plant"), PlanT(micro_plant()),
                  meta={"model": "plant",
                        "config": dataclasses.asdict(micro_plant())})


SMALL = ["--eval-towns", "synth3", "--eval-routes", "2", "--n-vehicles", "6"]


def entry_train_plant(tmp_path, monkeypatch, dev):
  out = tp.run(tp.parse_args(
      ["--towns", "synth", "--shards", "2", "--episodes", "2", "--frames",
       "20", "--steps", "6", "--segments", "3", "--batch", "8",
       "--eval-seeds", "1", "--eval-max-ticks", "8", "--out",
       str(tmp_path / "ck"), "--results", str(tmp_path / "r.json")] + SMALL),
      eval_chunk=8, device=dev)
  assert len(out["evals"]) == 3 and out["samples"] >= 8
  assert load_checkpoint(str(tmp_path / "ck"))[1]["model"] == "plant"


def entry_dagger_ab(tmp_path, monkeypatch, dev):
  out = da.run(da.parse_args(
      ["--towns", "synth", "synth2", "--segments", "3", "--seg-steps", "5",
       "--batch", "8", "--shards", "2", "--episodes", "2", "--frames", "20",
       "--dagger-frames", "20", "--eval-seeds", "1", "--eval-max-ticks", "8",
       "--results", str(tmp_path / "ab.json")] + SMALL),
      eval_chunk=8, device=dev)
  assert [r["arm"] for r in out["arms"]] == ["bc", "dagger"]


def entry_train_transfuser(tmp_path, monkeypatch, dev):
  out = str(tmp_path / "tf")
  res = tf.run(tf.parse_args(
      ["--micro", "--towns", "synth", "--eval-towns", "synth3", "--datasets",
       "1", "--episodes", "2", "--frames", "20", "--steps", "4",
       "--frames-per-step", "1", "--block-steps", "2", "--eval-every", "2",
       "--eval-routes", "1", "--final-eval-seeds", "1", "--min-vehicles",
       "4", "--max-vehicles", "8", "--eval-n-vehicles", "8", "--log-every",
       "1", "--out", out, "--results", f"{out}.json"]),
      eval_chunk=8, eval_max_ticks=8, device=dev)
  assert math.isfinite(res["transfuser_DS"])
  for name in ("_step2", "_step4", ""):
    sd, meta = load_checkpoint(out + name)
    assert meta["model"] == "transfuser" and all_finite(sd)


def entry_run_benchmarks(agent, extra):
  def run(tmp_path, monkeypatch, dev, root):
    monkeypatch.setattr(benchmark, "CARLA_CHUNK", 4)
    _micro_checkpoints(tmp_path)
    ck = {"transfuser": ["--checkpoint", str(tmp_path / "tf")],
          "plant": ["--checkpoint", str(tmp_path / "plant")]}.get(agent, [])
    args = rb.parse_args(["--agent", agent, "--max-ticks", "4",
                          "--n-vehicles", "4", "--benchmarks", "longest6",
                          "--results-dir", str(tmp_path / "out")] + ck +
                         extra)
    res = rb.run(args, device=dev, assets_root=root)["longest6"]
    back = json.loads(open(res["json"]).read())
    assert back["_checkpoint"]["records"] == res["records"] and res["records"]
  return run


def entry_bench(tmp_path, monkeypatch, dev):
  """bench.main with its points cut to the CPU test's sizes."""
  real_obj, real_sensor = bench.measure_object_level, bench.measure_sensor_on
  monkeypatch.setattr(bench, "measure_object_level", lambda device: real_obj(
      batch=2, ticks=2, rounds=1, device=device))
  monkeypatch.setattr(bench, "measure_sensor_on", lambda full, device:
                      real_sensor(full, ticks=2, rounds=1, batch=2,
                                  device=device))
  assert bench.main([], device=dev) == 0


def entry_bench_forward(tmp_path, monkeypatch, dev):
  assert bench_forward.main(["--micro", "--batch", "2", "--iters", "1",
                             "--profile", str(tmp_path / "trace")],
                            device=dev) == 0


ENTRY_POINTS = {
    "train_plant": entry_train_plant,
    "dagger_ab": entry_dagger_ab,
    "train_transfuser": entry_train_transfuser,
    "run_benchmarks_expert": entry_run_benchmarks(
        "expert", ["--single-batch", "--honest"]),
    "run_benchmarks_transfuser": entry_run_benchmarks(
        "transfuser", ["--towns", "Town01", "--jpeg-quality", "90"]),
    "run_benchmarks_plant": entry_run_benchmarks("plant", []),
    "bench": entry_bench,
    "bench_forward": entry_bench_forward,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_runs_on_the_card(cuda, entry, tmp_path, monkeypatch,
                                      request, every_launch_checked):
  """Each product entry point end to end on the card at its CPU test's
  sizes (synthetic towns, or the CPU tests' asset root for
  ``run_benchmarks``), every kernel launch equal to its plain version."""
  args = (tmp_path, monkeypatch, str(cuda))
  if entry.startswith("run_benchmarks"):
    args += (request.getfixturevalue("asset_root"),)
  ENTRY_POINTS[entry](*args)
  assert every_launch_checked.differing() == 0
