"""Reader of the reference's on-disk dataset layout, on the host (port of
carla_garage_tpu/train/legacy_dataset.py).

The reference trains from a ~350 GB dataset written by DataAgent
(data_agent.py:341-372): per-route directories with
  rgb/{frame:04d}.jpg              1024x256 camera
  semantics/{frame:04d}.png        semantic ids
  depth/{frame:04d}.png            24-bit encoded depth
  lidar/{frame:04d}.laz            laszip-compressed point cloud
  bev_semantics/{frame:04d}.png    BEV label map
  boxes/{frame:04d}.json.gz        ground-truth boxes
  measurements/{frame:04d}.json.gz ego measurements and labels
  results.json.gz                  route score (training filter,
                                   data.py:82-95: score_composed == 100)

Images decode through ``utils/image_io`` (no PIL). LiDAR is read as
``.lzc`` (``utils/lidar_codec``), ``.npy`` or ``.npz``, in that order;
``.laz`` needs laspy, which raises ImportError where it is missing. The
reference's own loader is data.py:238-696.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from carla_garage_tpu_torch.utils import image_io, lidar_codec


def route_is_perfect(route_dir: str) -> bool:
  """Training quality gate (data.py:91-95): expert DS == 100."""
  p = os.path.join(route_dir, "results.json.gz")
  if not os.path.exists(p):
    return False
  with gzip.open(p, "rt") as f:
    res = json.load(f)
  return float(res.get("scores", res).get("score_composed", 0.0)) >= 100.0


def scan_routes(root: str, require_perfect: bool = True) -> list[str]:
  """All route directories under root passing the quality gate."""
  out = []
  for d in sorted(os.listdir(root)):
    rd = os.path.join(root, d)
    if not os.path.isdir(rd) or not os.path.isdir(
        os.path.join(rd, "measurements")):
      continue
    if require_perfect and not route_is_perfect(rd):
      continue
    out.append(rd)
  return out


def load_measurement(route_dir: str, frame: int) -> dict:
  with gzip.open(os.path.join(route_dir, "measurements",
                              f"{frame:04d}.json.gz"), "rt") as f:
    return json.load(f)


def load_boxes(route_dir: str, frame: int) -> list[dict]:
  p = os.path.join(route_dir, "boxes", f"{frame:04d}.json.gz")
  if not os.path.exists(p):
    return []
  with gzip.open(p, "rt") as f:
    return json.load(f)


def load_rgb(route_dir: str, frame: int) -> np.ndarray:
  return image_io.read_jpeg(os.path.join(route_dir, "rgb",
                                         f"{frame:04d}.jpg"))


def load_semantics(route_dir: str, frame: int) -> np.ndarray:
  return image_io.read_png(os.path.join(route_dir, "semantics",
                                        f"{frame:04d}.png"))


def load_depth(route_dir: str, frame: int) -> np.ndarray:
  """Decode the reference's depth encoding (transfuser_utils.py:579):
  24-bit RGB -> normalized [0,1] depth."""
  img = image_io.read_png(os.path.join(route_dir, "depth",
                                       f"{frame:04d}.png")).astype(np.float32)
  if img.ndim == 2:
    return img / 255.0
  return (img[..., 0] + img[..., 1] * 256 +
          img[..., 2] * 256 * 256) / (256 ** 3 - 1)


def load_bev_semantics(route_dir: str, frame: int) -> np.ndarray:
  return image_io.read_png(os.path.join(route_dir, "bev_semantics",
                                        f"{frame:04d}.png"))


def load_lidar(route_dir: str, frame: int) -> np.ndarray:
  """[N,3] points from .lzc (native codec), .npy or .npz; .laz needs
  laspy."""
  base = os.path.join(route_dir, "lidar", f"{frame:04d}")
  if os.path.exists(base + ".lzc"):
    with open(base + ".lzc", "rb") as f:
      return lidar_codec.decompress(f.read())
  if os.path.exists(base + ".npy"):
    return np.load(base + ".npy").astype(np.float32)
  if os.path.exists(base + ".npz"):
    with np.load(base + ".npz") as z:
      return z[z.files[0]].astype(np.float32)
  if os.path.exists(base + ".laz"):
    try:
      import laspy
    except ImportError as e:
      raise ImportError(
          ".laz LiDAR needs laspy+laszip, which are not installed; "
          "convert offline with `laspy` to .npy, or use in-sim datagen"
      ) from e
    with laspy.open(base + ".laz") as f:
      pts = f.read()
      return np.stack([pts.X, pts.Y, pts.Z], -1).astype(np.float32)
  raise FileNotFoundError(base + ".{lzc,npy,npz,laz}")


def voxelize_lidar(points: np.ndarray, cfg) -> np.ndarray:
  """2-slice 256^2 histogram (data.py:873-906 semantics) -> [H,W,2]."""
  sc = cfg.sensor
  ppm = sc.lidar_resolution_height / (sc.max_y - sc.min_y)
  xs = ((points[:, 0] - sc.min_x) * ppm).astype(np.int64)
  ys = ((points[:, 1] - sc.min_y) * ppm).astype(np.int64)
  H = sc.lidar_resolution_height
  W = sc.lidar_resolution_width
  inb = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
  below = points[:, 2] < sc.lidar_split_height
  out = np.zeros((H, W, 2), np.float32)
  for ci, m in enumerate((below, ~below)):
    sel = inb & m
    np.add.at(out[..., ci], (ys[sel], xs[sel]), 1.0)
  return np.minimum(out, sc.hist_max_per_pixel) / sc.hist_max_per_pixel


def load_frame(route_dir: str, frame: int, cfg) -> dict:
  """One complete training sample from disk (the CARLA_Data.__getitem__
  analog, data.py:238-696): images, voxelized LiDAR, measurements."""
  m = load_measurement(route_dir, frame)
  out = {
      "rgb": load_rgb(route_dir, frame),
      "lidar_bev": voxelize_lidar(load_lidar(route_dir, frame), cfg),
      "speed": np.float32(m.get("speed", 0.0)),
      "target_point": np.asarray(m.get("target_point", [0.0, 0.0]),
                                 np.float32),
      "command": np.int32(m.get("command", 4)),
      "steer": np.float32(m.get("steer", 0.0)),
      "throttle": np.float32(m.get("throttle", 0.0)),
      "brake": np.float32(m.get("brake", 0.0)),
      "target_speed": np.float32(m.get("target_speed", 0.0)),
      "boxes": load_boxes(route_dir, frame),
      "measurements": m,
  }
  name = f"{frame:04d}.png"
  if os.path.exists(os.path.join(route_dir, "semantics", name)):
    out["semantic"] = load_semantics(route_dir, frame)
  if os.path.exists(os.path.join(route_dir, "depth", name)):
    out["depth"] = load_depth(route_dir, frame)
  if os.path.exists(os.path.join(route_dir, "bev_semantics", name)):
    out["bev_semantic"] = load_bev_semantics(route_dir, frame)
  return out


def iterate_dataset(root: str, cfg, sampling_rate: int = 1,
                    require_perfect: bool = True):
  """Yield (route_dir, frame_index, sample) over the whole dataset
  (train_sampling_rate thinning, config.py:117)."""
  for rd in scan_routes(root, require_perfect):
    meas = sorted(os.listdir(os.path.join(rd, "measurements")))
    for i, name in enumerate(meas):
      if i % sampling_rate:
        continue
      frame = int(name.split(".")[0])
      yield rd, frame, load_frame(rd, frame, cfg)
