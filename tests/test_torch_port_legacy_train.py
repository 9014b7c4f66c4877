"""Port parity: the disk path end to end, torch vs JAX on the CPU.

Both exporters write the same two-episode datagen run (the sizes of
``tests/test_legacy_train.py``: a 32x128 camera, a 16x-decimated LiDAR half
sweep, 16 frames) with the JAX exporter's LiDAR draws
(``uniform(key(0))`` for the rendered batch, ``uniform(key(1))`` for the
raw sweep) replayed into the port; the port then reads the JAX-written
dataset as JAX does, and both disk trainers take 3 steps from the same
weights on the same samples. JAX writes its images through PIL, the port
through its own codec; the JAX renderers take their plain path, as JAX's
own test of the exporter does.
"""

import dataclasses
import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.sensors.camera import camera_ray_grid
from carla_garage_tpu.sensors.lidar import lidar_ray_grid
from carla_garage_tpu.sim.datagen import collect_expert_frames
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu.train import legacy_train as jlt
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.train import legacy_train as lt
from carla_garage_tpu_torch.utils import image_io, lidar_codec
from test_torch_port_scene import jax_batch_to_port, to_port

B = 2
CAM = camera_ray_grid(JCFG, scale=8)            # 32 x 128
LID = lidar_ray_grid(JCFG, half=0, decimate=16)
TCFG = dataclasses.replace(
    jtf.micro_config(), img_h=32, img_w=128, lidar_h=256, lidar_w=256,
    img_anchors=(1, 4), lidar_anchors=(8, 8))
T = lambda a: torch.from_numpy(np.array(a))
# the port's JPEG of a camera frame against PIL's of the same frame, both
# decoded (4:2:0, quality 90): a pixel whose float render differs from
# JAX's by a few ulps can truncate to the next level, which the DCT then
# spreads over its block
JPEG_MAX, JPEG_MEAN = 3, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
  root = tmp_path_factory.mktemp("disk")
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=3, n_vehicles=4, n_walkers=2)
  _, frames = jax.jit(lambda sc, st: collect_expert_frames(
      JCFG, maps, lanes, sc, st, n_frames=16))(scene, state)
  j_routes = jlt.export_reference_layout(str(root / "jax"), JCFG, maps,
                                         scene, frames, CAM, LID)
  n = LID.shape[0] * LID.shape[1]
  t_maps, _, t_scene, _ = jax_batch_to_port(maps, lanes, scene, state)
  t_routes = lt.export_reference_layout(
      str(root / "port"), CFG, t_maps, t_scene, to_port(frames, Frames),
      CAM, LID, uniform_render=T(jax.random.uniform(jax.random.key(0),
                                                    (B, n))),
      uniform_points=T(jax.random.uniform(jax.random.key(1), (B, n))))
  return root, j_routes, t_routes


def files_under(d):
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


def jpeg_close(got, want, what):
  d = np.abs(got.astype(np.int16) - want.astype(np.int16))
  assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN, (what, d.max(),
                                                         d.mean())
  return d


def test_export_writes_jax_files(exported):
  root, j_routes, t_routes = exported
  assert [os.path.basename(r) for r in t_routes] == \
      [os.path.basename(r) for r in j_routes]
  names = files_under(root / "jax")
  assert files_under(root / "port") == names
  worst = {"rgb": 0, "lidar": 0.0}
  n_points = 0
  for name in names:
    j, t = root / "jax" / name, root / "port" / name
    kind = name.split(os.sep)[1]
    if name.endswith(".json.gz"):
      with gzip.open(j, "rt") as fj, gzip.open(t, "rt") as ft:
        json_close(json.load(ft), json.load(fj), name)
    elif kind == "rgb":
      d = jpeg_close(image_io.read_jpeg(t), np.asarray(Image.open(j)), name)
      worst["rgb"] = max(worst["rgb"], int(d.max()))
    elif name.endswith(".png"):
      # the depth PNG too: its 24-bit code of depth / 85 would show a
      # difference of an ulp in the render, and there is none
      np.testing.assert_array_equal(image_io.read_png(t),
                                    np.asarray(Image.open(j)), err_msg=name)
    else:
      pj = lidar_codec.decompress(j.read_bytes())
      pt = lidar_codec.decompress(t.read_bytes())
      assert pt.shape == pj.shape, (name, pt.shape, pj.shape)
      # the renders agree to 1e-5 m; each side rounds to its own 2 mm grid
      err = float(np.abs(pt - pj).max()) if len(pj) else 0.0
      assert err <= 1e-5 + lidar_codec.DEFAULT_SCALE, (name, err)
      worst["lidar"] = max(worst["lidar"], err)
      n_points += len(pj)
  assert n_points > 0
  print(f"{len(names)} files; worst rgb {worst['rgb']} levels, LiDAR "
        f"{worst['lidar']:.3g} m over {n_points} points")


def test_load_disk_samples_match_jax(exported):
  root, _, _ = exported
  want = jlt.load_disk_samples(str(root / "jax"), JCFG, TCFG)
  got = lt.load_disk_samples(str(root / "jax"), CFG, TCFG)
  assert len(got) == len(want) >= 8
  for i, (g, w) in enumerate(zip(got, want)):
    assert set(g) == set(w)
    for k in w:
      # rgb too: the port decodes PIL's JPEGs to PIL's pixels
      np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i}/{k}")


def test_port_reads_its_own_export(exported):
  root, _, t_routes = exported
  samples = lt.load_disk_samples(str(root / "port"), CFG, TCFG)
  assert len(samples) >= 8
  s = samples[0]
  assert s["rgb"].shape == (32, 128, 3) and s["semantic"].shape == (32, 128)
  assert s["lidar_bev"].shape == (256, 256, 2) and s["wp_label"].shape == (8,
                                                                            2)
  batch = lt.make_disk_batch(CFG, TCFG, samples, [0, 1], (64, 64), "cpu")
  assert batch["centernet"]["heatmap"].shape == (2, 64, 64, 4)
  assert batch["bev_semantic_ds"].shape == (2, 256, 256)


def test_disk_path_refuses_cuda_without_a_card(exported):
  """The trainer and the batch builder run on the card unless the caller
  names the CPU; without one they raise before any work."""
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device is usable")
  root, _, _ = exported
  with pytest.raises(RuntimeError, match="cuda"):
    lt.train_transfuser_from_disk(str(root / "port"), CFG, TCFG, steps=1)
  samples = lt.load_disk_samples(str(root / "port"), CFG, TCFG)
  with pytest.raises(RuntimeError, match="cuda"):
    lt.make_disk_batch(CFG, TCFG, samples, [0], (64, 64))


def test_train_from_disk_tracks_jax(exported, monkeypatch):
  """3 steps of each disk trainer from JAX's initial weights on JAX's
  samples (rgb decoded by PIL, handed to both), with the same batches.

  One step's gradients differ by about 3.2e-4 of their norm
  (test_torch_port_train.py; float32 through ~30 layers). AdamW's first
  steps move every weight by about lr whatever the size of its gradient,
  so a weight whose gradient is within that error of zero can move the
  other way on one side, and the difference grows with each step: the
  losses of steps 0-2 differ by 0, 3e-5 and 9.3e-5 of their value, the
  final weights by 4.5% of the update's norm, spread over many
  small-gradient entries, and the loss they give on a fixed batch by
  2.8e-4 (measured). The bars: 5e-4 a logged loss, 10% of the update's
  norm, 1e-3 the final weights' loss."""
  root, _, _ = exported
  samples = jlt.load_disk_samples(str(root / "jax"), JCFG, TCFG)
  jm = jtf.LidarCenterNet(TCFG)
  b0 = jlt.make_disk_batch(JCFG, TCFG, samples, [0, 0], (64, 64))
  params = jax.jit(jm.init)(jax.random.key(0), b0["rgb"], b0["lidar_bev"],
                            b0["target_point"], b0["command_onehot"],
                            b0["speed"])
  monkeypatch.setattr(jlt, "load_disk_samples", lambda *a, **k: samples)
  monkeypatch.setattr(lt, "load_disk_samples", lambda *a, **k: samples)
  kw = dict(steps=3, batch_size=4, lr=1e-3, seed=5, log_every=1)
  j_params, j_hist = jlt.train_transfuser_from_disk(
      "unused", JCFG, TCFG, params=params, **kw)
  tcfg = ttf.TransfuserConfig(**dataclasses.asdict(TCFG))
  as_port = lambda p: load_flax_params(ttf.LidarCenterNet(tcfg),
                                       jax.tree.map(np.asarray, p))
  start = as_port(params)
  model, hist = lt.train_transfuser_from_disk(
      "unused", CFG, TCFG, params=start.state_dict(), device="cpu", **kw)
  assert [h["step"] for h in hist] == [h["step"] for h in j_hist] == [0, 1,
                                                                      2]
  for h, jh in zip(hist, j_hist):
    assert abs(h["loss"] - jh["loss"]) <= 5e-4 * abs(jh["loss"]), (h, jh)
  want = as_port(j_params)
  old, got = dict(start.named_parameters()), dict(model.named_parameters())
  new = dict(want.named_parameters())
  upd = np.sqrt(sum(float(((new[n] - old[n]) ** 2).sum()) for n in old))
  diff = np.sqrt(sum(float(((got[n] - new[n]) ** 2).sum()) for n in old))
  assert diff <= 0.1 * upd, diff / upd
  batch = lt.make_disk_batch(CFG, TCFG, samples, [1, 2, 3, 4], (64, 64),
                             "cpu")
  with torch.no_grad():
    loss_port = float(lt.transfuser_loss(CFG, tcfg, model, None, batch)[0])
    loss_jax = float(lt.transfuser_loss(CFG, tcfg, want, None, batch)[0])
  assert abs(loss_port - loss_jax) <= 1e-3 * abs(loss_jax), (loss_port,
                                                             loss_jax)
