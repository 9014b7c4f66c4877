"""Port parity: geodesy, the .lzc LiDAR codec, dataset files and the
reference-layout reader, torch vs JAX on the CPU.

The reader runs on the fixture of ``tests/test_legacy_dataset.py`` (a
route directory whose images PIL wrote); the dataset files are the npz
shards of JAX's ``dataset_io`` read by the port and the port's read by
JAX.
"""

import dataclasses
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.sim.datagen import Frames as JFrames
from carla_garage_tpu.train import dataset_io as jdio
from carla_garage_tpu.train import legacy_dataset as jld
from carla_garage_tpu.train.plant_train import PlantDataset as JPlantDataset
from carla_garage_tpu.utils import geodesy as jgeo
from carla_garage_tpu.utils import lidar_codec as jlc
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.sim.datagen import Frames
from carla_garage_tpu_torch.train import dataset_io, legacy_dataset as ld
from carla_garage_tpu_torch.utils import geodesy, lidar_codec



def sweep(seed, n=5000):
  """A scan-ordered ring sweep (tests/test_round4_features.py:184)."""
  rng = np.random.default_rng(seed)
  az = np.linspace(-np.pi, np.pi, n)
  r = 15 + 8 * np.sin(2 * az) + rng.normal(0, 0.02, az.shape)
  return np.stack([r * np.cos(az), r * np.sin(az),
                   rng.normal(1.0, 0.05, az.shape)], -1).astype(np.float32)


def test_geodesy_matches_jax():
  rng = np.random.default_rng(0)
  ll = np.stack([rng.uniform(-0.01, 0.01, 50), rng.uniform(-0.01, 0.01, 50)],
                -1)
  np.testing.assert_array_equal(geodesy.gps_to_carla(ll),
                                jgeo.gps_to_carla(ll))
  xy = rng.uniform(-500, 500, (50, 2))
  for ref in ({}, dict(lat_ref=48.1, lon_ref=11.5)):
    np.testing.assert_array_equal(geodesy.location_to_gps(xy, **ref),
                                  jgeo.location_to_gps(xy, **ref))
  # the round trip through GPS is close to the identity (exactness of the
  # inverse is not claimed by either package)
  back = geodesy.gps_to_carla(geodesy.location_to_gps(xy, 0.0, 0.0))
  assert np.abs(back - xy).max() < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lzc_native_bytes_match_jax(seed):
  pts = sweep(seed)
  blob = lidar_codec.compress(pts)
  assert blob == jlc.compress(pts)
  back = lidar_codec.decompress(blob)
  np.testing.assert_array_equal(back, jlc.decompress(blob))
  assert np.abs(back - pts).max() <= 1.1e-3       # 2 mm quantization
  assert len(blob) < pts.nbytes / 2.5             # it compresses


@pytest.mark.parametrize("seed", [0, 1])
def test_lzc_plain_matches_jax_numpy(seed):
  pts = sweep(seed, 700)
  blob = lidar_codec.compress_plain(pts)
  assert blob == jlc._compress_py(pts, lidar_codec.DEFAULT_SCALE)
  # cross-decoding: each decoder reads the other encoder's bytes
  native = lidar_codec.compress(pts)
  np.testing.assert_array_equal(lidar_codec.decompress_plain(native),
                                lidar_codec.decompress(native))
  np.testing.assert_array_equal(lidar_codec.decompress(blob),
                                jlc._decompress_py(blob))
  np.testing.assert_array_equal(lidar_codec.decompress_plain(blob),
                                lidar_codec.decompress(blob))


def test_lzc_empty_cloud():
  empty = np.zeros((0, 3), np.float32)
  for enc in (lidar_codec.compress, lidar_codec.compress_plain):
    blob = enc(empty)
    assert blob == jlc.compress(empty)
    assert lidar_codec.decompress(blob).shape == (0, 3)
    assert lidar_codec.decompress_plain(blob).shape == (0, 3)


def test_lzc_ties_round_differently():
  """Points at exact half-quanta: the native encoder rounds them away from
  zero (lround), the numpy one to even (np.round). Both byte strings are
  valid .lzc; they decode one quantum apart, which is why ``compress``
  never falls back from one to the other."""
  scale = 0.5                       # exact in float32, as is 1 / scale
  pts = np.zeros((4, 3), np.float32)
  pts[:, 0] = [0.0, 0.25, 0.75, 1.25]       # 0, 0.5, 1.5, 2.5 quanta
  native, plain = (lidar_codec.compress(pts, scale),
                   lidar_codec.compress_plain(pts, scale))
  assert native != plain
  assert native == jlc.compress(pts, scale)
  assert plain == jlc._compress_py(pts, scale)
  np.testing.assert_array_equal(lidar_codec.decompress(native)[:, 0],
                                [0.0, 0.5, 1.0, 1.5])
  np.testing.assert_array_equal(lidar_codec.decompress(plain)[:, 0],
                                [0.0, 0.0, 1.0, 1.0])


def test_lzc_raises_without_its_native_library(tmp_path, monkeypatch):
  """No .so and no source to build: compress raises instead of switching to
  the numpy encoder (JAX's does switch, silently)."""
  monkeypatch.setattr(lidar_codec, "NATIVE_DIR", tmp_path)
  monkeypatch.setattr(lidar_codec, "_LIB", None)
  with pytest.raises((OSError, RuntimeError)):
    lidar_codec.compress(sweep(0, 50))
  with pytest.raises((OSError, RuntimeError)):
    lidar_codec.decompress(jlc.compress(sweep(0, 50)))


def test_lzc_raises_on_malformed_data():
  blob = lidar_codec.compress(sweep(0, 100))
  with pytest.raises(ValueError):
    lidar_codec.decompress(blob[:-5])
  with pytest.raises(ValueError):
    lidar_codec.decompress(blob[:10])


def random_frames(rng, F=3, B=2, V=4, W=2):
  f32 = lambda *s: rng.normal(size=s).astype(np.float32)
  b = lambda *s: rng.uniform(size=s) > 0.5
  i32 = lambda *s: rng.integers(0, 5, s).astype(np.int32)
  fields = dict(
      ego_pos=f32(F, B, 2), ego_yaw=f32(F, B), ego_speed=f32(F, B),
      veh_pos=f32(F, B, V, 2), veh_yaw=f32(F, B, V), veh_speed=f32(F, B, V),
      veh_brake=f32(F, B, V), veh_extent=f32(F, B, V, 2),
      veh_valid=b(F, B, V), wlk_pos=f32(F, B, W, 2), wlk_yaw=f32(F, B, W),
      wlk_speed=f32(F, B, W), wlk_extent=f32(F, B, W, 2),
      wlk_valid=b(F, B, W), target_point=f32(F, B, 2), command=i32(F, B),
      dense_idx=i32(F, B), steer=f32(F, B), throttle=f32(F, B),
      brake=f32(F, B), target_speed=f32(F, B), junction=b(F, B),
      light_hazard=b(F, B), stop_hazard=b(F, B), time_s=f32(F, B),
      alive=b(F, B))
  assert set(fields) == {f.name for f in dataclasses.fields(Frames)} == \
      {f.name for f in dataclasses.fields(JFrames)}
  return fields


def test_frames_files_interchange_with_jax(tmp_path):
  fields = random_frames(np.random.default_rng(0))
  jdio.save_frames(JFrames(**{k: jnp.asarray(v) for k, v in fields.items()}),
                   str(tmp_path / "jax.npz"))
  got = dataset_io.load_frames(str(tmp_path / "jax.npz"), device="cpu")
  for k, v in fields.items():
    x = getattr(got, k)
    assert x.dtype == torch.from_numpy(v).dtype, k
    np.testing.assert_array_equal(x.numpy(), v, err_msg=k)
  dataset_io.save_frames(got, str(tmp_path / "sub" / "port.npz"))
  back = jdio.load_frames(str(tmp_path / "sub" / "port.npz"))
  for k, v in fields.items():
    w = np.asarray(getattr(back, k))
    assert w.dtype == v.dtype, k
    np.testing.assert_array_equal(w, v, err_msg=k)


def test_load_frames_refuses_cuda_without_a_card(tmp_path):
  fields = random_frames(np.random.default_rng(1))
  dataset_io.save_frames(Frames(**{k: torch.from_numpy(v)
                                   for k, v in fields.items()}),
                         str(tmp_path / "f.npz"))
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device is usable")
  with pytest.raises(RuntimeError, match="cuda"):
    dataset_io.load_frames(str(tmp_path / "f.npz"))


@pytest.mark.parametrize("with_wp_weight", [False, True])
def test_plant_dataset_files_interchange_with_jax(tmp_path, with_wp_weight):
  rng = np.random.default_rng(2)
  N, O, R = 5, 3, 4
  fields = dict(
      boxes=rng.normal(size=(N, O, 7)).astype(np.float32),
      box_types=rng.integers(0, 3, (N, O)).astype(np.int32),
      route=rng.normal(size=(N, R, 2)).astype(np.float32),
      light=rng.uniform(size=N).astype(np.float32),
      stop=rng.uniform(size=N).astype(np.float32),
      junction=rng.uniform(size=N).astype(np.float32),
      velocity=rng.uniform(size=N).astype(np.float32),
      target_point=rng.normal(size=(N, 2)).astype(np.float32),
      wp_label=rng.normal(size=(N, 8, 2)).astype(np.float32),
      speed_label=rng.integers(0, 4, N).astype(np.int32),
      ckpt_label=rng.normal(size=(N, R, 2)).astype(np.float32),
      forecast_label=rng.integers(-999, 5, (N, O, 7)).astype(np.int32))
  if with_wp_weight:
    fields["wp_weight"] = np.array([1, 0, 1, 1, 0], np.float32)
  # without a DAgger weight JAX stores wp_weight as a pickled None, which
  # its own loader refuses; the port reads the file, leaving it None
  jdio.save_plant_dataset(JPlantDataset(**fields), str(tmp_path / "j.npz"))
  got = dataset_io.load_plant_dataset(str(tmp_path / "j.npz"), device="cpu")
  assert (got.wp_weight is None) != with_wp_weight
  for k, v in fields.items():
    np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
  dataset_io.save_plant_dataset(got, str(tmp_path / "p.npz"))
  back = jdio.load_plant_dataset(str(tmp_path / "p.npz"))
  assert (back.wp_weight is None) != with_wp_weight
  for k, v in fields.items():
    np.testing.assert_array_equal(getattr(back, k), v, err_msg=k)


@pytest.fixture
def fake_route(tmp_path):
  """The fixture of tests/test_legacy_dataset.py: three frames whose images
  PIL wrote, .npy LiDAR, measurements and boxes."""
  rd = tmp_path / "Route_00"
  for sub in ("rgb", "semantics", "depth", "lidar", "measurements",
              "boxes", "bev_semantics"):
    (rd / sub).mkdir(parents=True)
  rng = np.random.default_rng(0)
  for f in range(3):
    Image.fromarray(rng.integers(0, 255, (64, 128, 3), np.uint8),
                    "RGB").save(rd / "rgb" / f"{f:04d}.jpg")
    Image.fromarray(rng.integers(0, 7, (64, 128), np.uint8).astype(
        np.uint8)).save(rd / "semantics" / f"{f:04d}.png")
    Image.fromarray(rng.integers(0, 255, (64, 128, 3), np.uint8),
                    "RGB").save(rd / "depth" / f"{f:04d}.png")
    Image.fromarray(rng.integers(0, 11, (96, 96), np.uint8)).save(
        rd / "bev_semantics" / f"{f:04d}.png")
    pts = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    np.save(rd / "lidar" / f"{f:04d}.npy", pts)
    with gzip.open(rd / "measurements" / f"{f:04d}.json.gz", "wt") as fh:
      json.dump({"speed": 3.0, "target_point": [10.0, 1.0], "command": 4,
                 "steer": 0.05, "throttle": 0.6, "brake": 0.0,
                 "target_speed": 8.0}, fh)
    with gzip.open(rd / "boxes" / f"{f:04d}.json.gz", "wt") as fh:
      json.dump([{"class": "car", "position": [5, 1, 0],
                  "extent": [2.2, 1.0, 0.7], "yaw": 0.1}], fh)
  with gzip.open(rd / "results.json.gz", "wt") as fh:
    json.dump({"scores": {"score_composed": 100.0}}, fh)
  return tmp_path


def assert_sample_equal(got, want, what):
  assert set(got) == set(want), what
  for k, w in want.items():
    if isinstance(w, np.ndarray):
      # rgb too: the port decodes a JPEG to PIL's pixels (image_io tests)
      assert got[k].dtype == w.dtype and got[k].shape == w.shape, (what, k)
      np.testing.assert_array_equal(got[k], w, err_msg=f"{what}/{k}")
    else:
      assert got[k] == w and type(got[k]) is type(w), (what, k)


def test_load_frame_matches_jax(fake_route):
  rd = str(fake_route / "Route_00")
  assert ld.scan_routes(str(fake_route)) == jld.scan_routes(str(fake_route))
  for f in range(3):
    assert_sample_equal(ld.load_frame(rd, f, CFG), jld.load_frame(rd, f, JCFG),
                        f"frame {f}")


def test_scan_gate_and_iterate_match_jax(fake_route):
  bad = fake_route / "Route_01"
  (bad / "measurements").mkdir(parents=True)
  with gzip.open(bad / "results.json.gz", "wt") as fh:
    json.dump({"scores": {"score_composed": 71.0}}, fh)
  (fake_route / "notes").mkdir()
  root = str(fake_route)
  for perfect in (True, False):
    assert ld.scan_routes(root, perfect) == jld.scan_routes(root, perfect)
  assert not ld.route_is_perfect(str(bad))
  got = list(ld.iterate_dataset(root, CFG, sampling_rate=2))
  want = list(jld.iterate_dataset(root, JCFG, sampling_rate=2))
  assert [(r, f) for r, f, _ in got] == [(r, f) for r, f, _ in want] == \
      [(os.path.join(root, "Route_00"), 0), (os.path.join(root, "Route_00"),
                                              2)]
  for (_, f, g), (_, _, w) in zip(got, want):
    assert_sample_equal(g, w, f"frame {f}")


def test_lidar_lookup_order_matches_jax(fake_route):
  rd = fake_route / "Route_00"
  pts = sweep(4, 300)
  (rd / "lidar" / "0001.npy").unlink()
  np.savez(rd / "lidar" / "0001.npz", cloud=pts)
  (rd / "lidar" / "0002.lzc").write_bytes(lidar_codec.compress(pts))
  (rd / "lidar" / "0003.laz").write_bytes(b"laz")
  for f in (0, 1, 2):            # .npy, .npz, and .lzc before .npy
    np.testing.assert_array_equal(ld.load_lidar(str(rd), f),
                                  jld.load_lidar(str(rd), f))
  np.testing.assert_array_equal(ld.load_lidar(str(rd), 2),
                                lidar_codec.decompress(
                                    lidar_codec.compress(pts)))
  try:
    import laspy  # noqa: F401
  except ImportError:
    with pytest.raises(ImportError, match="laspy"):
      ld.load_lidar(str(rd), 3)
  with pytest.raises(FileNotFoundError):
    ld.load_lidar(str(rd), 9)


def test_voxelize_lidar_matches_jax():
  rng = np.random.default_rng(3)
  pts = np.concatenate([rng.uniform(-40, 40, (4000, 3)),
                        np.repeat([[1.0, 2.0, -1.0]], 30, 0)]).astype(
                            np.float32)
  got = ld.voxelize_lidar(pts, CFG)
  np.testing.assert_array_equal(got, jld.voxelize_lidar(pts, JCFG))
  assert got.max() == 1.0 and got.shape == (256, 256, 2)

