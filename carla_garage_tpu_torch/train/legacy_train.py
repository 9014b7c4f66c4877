"""Training on the reference's on-disk dataset layout (the data.py:238-696
-> train.py:643-996 path), and the exporter that writes that layout (port
of carla_garage_tpu/train/legacy_train.py).

Two halves:
  * export_reference_layout: in-sim datagen Frames -> per-route
    directories in the reference DataAgent layout (data_agent.py:341-372):
    rgb JPEG (quality 90, 4:2:0), semantics / depth / BEV PNG (24-bit
    depth encoding, transfuser_utils.py:579), the raw LiDAR sweep as
    ``.lzc`` (the laszip role), boxes and measurements as json.gz, and the
    results.json.gz quality gate. Sensors and labels are rendered on the
    device through both kernels (``render_frame_batch`` and a second LiDAR
    cast for the raw sweep, as the JAX package does); files are encoded
    and written on the host.
  * train_transfuser_from_disk: scan_routes -> host batches (stored boxes
    splatted to CenterNet targets through the same ``centernet_targets``
    as in-sim training) -> ``transfuser_loss`` steps on the device.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os

import numpy as np
import torch

from carla_garage_tpu_torch.agents.sensor_agent import command_onehot
from carla_garage_tpu_torch.config import GlobalConfig
from carla_garage_tpu_torch.device import resolve_device
from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                      TransfuserConfig)
from carla_garage_tpu_torch.sensors.lidar import render_lidar
from carla_garage_tpu_torch.sim import geometry as geo
from carla_garage_tpu_torch.sim.datagen import (PRED_LEN, Frames,
                                                checkpoint_labels)
from carla_garage_tpu_torch.train import legacy_dataset as ld
from carla_garage_tpu_torch.train.transfuser_train import (
    centernet_targets, frame_state, render_frame_batch, transfuser_loss)
from carla_garage_tpu_torch.utils import image_io, lidar_codec

CLASS_NAMES = {0: "car", 1: "walker", 2: "traffic_light", 3: "stop_sign"}
CLASS_IDS = {v: k for k, v in CLASS_NAMES.items()}
SUBDIRS = ("rgb", "semantics", "depth", "lidar", "bev_semantics", "boxes",
           "measurements")
JPEG_QUALITY = 90


def _encode_depth_24bit(depth01: np.ndarray) -> np.ndarray:
  """[H,W] in [0,1] -> uint8 [H,W,3] (transfuser_utils.py:579 inverse)."""
  q = np.clip(depth01, 0.0, 1.0) * (256 ** 3 - 1)
  q = q.astype(np.int64)
  return np.stack([q % 256, (q // 256) % 256, q // 65536],
                  -1).astype(np.uint8)


def _dump_gz(path: str, obj):
  with gzip.open(path, "wt") as f:
    json.dump(obj, f)


def _frame_on_host(cfg, maps, scene, frames, f_idx, cam, lid, u_render,
                   u_points) -> dict:
  """Frame f_idx of every episode rendered on the device, with the
  ego-frame boxes and the raw LiDAR sweep, copied to the host."""
  r = render_frame_batch(cfg, maps, scene, frames, f_idx, cam, lid,
                         uniform=u_render)
  pts, pval = render_lidar(cfg, maps, scene, frame_state(frames, f_idx),
                           lid, uniform=u_points)
  rel = geo.world_to_ego(r["obj_pos"], r["ego_pos"][:, None],
                         r["ego_yaw"][:, None])
  out = dict(
      rgb=(torch.clamp(r["rgb"], 0, 1) * 255).to(torch.uint8),
      semantic=r["semantic"].to(torch.uint8), depth=r["depth"],
      bev=r["bev_semantic"].to(torch.uint8), pts=pts, pval=pval, rel=rel,
      ryaw=r["obj_yaw"] - r["ego_yaw"][:, None])
  for k in ("obj_valid", "obj_cls", "obj_extent", "obj_speed",
            "obj_brake"):
    out[k] = r[k]
  return {k: v.cpu().numpy() for k, v in out.items()}


def _boxes(h: dict, b: int) -> list:
  """The valid boxes of episode b in the ego frame (data_agent.py:383-570
  layout)."""
  boxes = []
  for i in range(h["rel"].shape[1]):
    if not h["obj_valid"][b, i]:
      continue
    rel = h["rel"][b, i]
    boxes.append({
        "class": CLASS_NAMES[int(h["obj_cls"][b, i])],
        "position": [float(rel[0]), float(rel[1]), 0.0],
        "extent": [float(h["obj_extent"][b, i, 0]),
                   float(h["obj_extent"][b, i, 1]), 1.0],
        "yaw": float(h["ryaw"][b, i]),
        "speed": float(h["obj_speed"][b, i]),
        "brake": float(h["obj_brake"][b, i]),
        "num_points": -1, "distance": float(np.linalg.norm(rel)), "id": i,
    })
  return boxes


def _measurement(fr: dict, ckpt: np.ndarray, f: int, b: int) -> dict:
  return {
      "pos_global": [float(fr["ego_pos"][f, b, 0]),
                     float(fr["ego_pos"][f, b, 1])],
      "theta": float(fr["ego_yaw"][f, b]),
      "speed": float(fr["ego_speed"][f, b]),
      "target_speed": float(fr["target_speed"][f, b]),
      "steer": float(fr["steer"][f, b]),
      "throttle": float(fr["throttle"][f, b]),
      "brake": float(fr["brake"][f, b]),
      "command": int(fr["command"][f, b]),
      "target_point": [float(fr["target_point"][f, b, 0]),
                       float(fr["target_point"][f, b, 1])],
      "route": ckpt[f, b].tolist(),
      "alive": bool(fr["alive"][f, b]),
  }


def export_reference_layout(out_root: str, cfg: GlobalConfig, maps, scene,
                            frames: Frames, camera_grid, lidar_grid,
                            uniform_render: torch.Tensor | None = None,
                            uniform_points: torch.Tensor | None = None,
                            route_prefix: str = "route", episodes=None,
                            generator: torch.Generator | None = None
                            ) -> list[str]:
  """Write in-sim datagen frames as reference-layout route directories.

  One directory per episode (batch element). Episodes whose frames are
  all quality-gated out (frames.alive False everywhere) get score 0 in
  results.json.gz so that scan_routes drops them (the data.py:91-95
  gate). The tensors lie on one device; a frame is rendered there, then
  encoded and written on the host.

  uniform_render / uniform_points [B,N]: the LiDAR dropoff draws of the
  rendered batch (its BEV histogram and detection gate) and of the raw
  sweep written to lidar/, one set used at every frame as the JAX package
  uses its fixed keys; each drawn once from `generator` when None.
  Returns the route directories written."""
  dev = frames.ego_pos.device
  F, B = frames.ego_yaw.shape
  episodes = range(B) if episodes is None else episodes
  cam = torch.as_tensor(camera_grid, device=dev)
  lid = torch.as_tensor(lidar_grid, device=dev).reshape(-1, 3)
  draw = lambda u: torch.rand((B, lid.shape[0]), generator=generator,
                              device=dev) if u is None else u
  u_render, u_points = draw(uniform_render), draw(uniform_points)
  fr = {f.name: getattr(frames, f.name).cpu().numpy()
        for f in dataclasses.fields(frames)}
  ckpt = checkpoint_labels(frames, scene, n_ckpt=10).cpu().numpy()

  routes = {}
  for b in episodes:
    rd = routes[b] = os.path.join(out_root, f"{route_prefix}_{b:03d}")
    for sub in SUBDIRS:
      os.makedirs(os.path.join(rd, sub), exist_ok=True)
    clean = bool(fr["alive"][:, b].any())
    _dump_gz(os.path.join(rd, "results.json.gz"),
             {"scores": {"score_composed": 100.0 if clean else 0.0}})

  for f_idx in range(F):
    h = _frame_on_host(cfg, maps, scene, frames, f_idx, cam, lid, u_render,
                       u_points)
    name = f"{f_idx:04d}"
    for b, rd in routes.items():
      path = lambda sub, ext: os.path.join(rd, sub, f"{name}.{ext}")
      image_io.write_jpeg(path("rgb", "jpg"), h["rgb"][b],
                          quality=JPEG_QUALITY)
      image_io.write_png(path("semantics", "png"), h["semantic"][b])
      image_io.write_png(path("depth", "png"),
                         _encode_depth_24bit(h["depth"][b] / 85.0))
      image_io.write_png(path("bev_semantics", "png"), h["bev"][b])
      with open(path("lidar", "lzc"), "wb") as f:
        f.write(lidar_codec.compress(h["pts"][b][h["pval"][b]]))
      _dump_gz(path("boxes", "json.gz"), _boxes(h, b))
      _dump_gz(path("measurements", "json.gz"),
               _measurement(fr, ckpt, f_idx, b))
  return list(routes.values())


def _speed_class(cfg: GlobalConfig, target_speed: float,
                 brake: float) -> int:
  """target_speed_labels binning (config.py:144-148 analog)."""
  e = cfg.expert
  if brake > 0.5 or target_speed <= 0.01:
    return 0
  if target_speed <= e.target_speed_walker + 0.1:
    return 1
  if target_speed <= e.target_speed_slow + 0.1:
    return 2
  return 3


def load_disk_samples(root: str, cfg: GlobalConfig, tcfg: TransfuserConfig,
                      sampling_rate: int = 1, max_objects: int = 48):
  """Scan a reference-layout dataset into a list of host samples (dicts of
  numpy arrays).

  Stored boxes become obj_* arrays in the EGO frame (centernet_targets
  then runs with the ego at the origin); waypoint labels come from future
  measurements' global pose (data.py:812-838) and checkpoint labels from
  the stored route (data.py:1066-1138)."""
  out = []
  for rd in ld.scan_routes(root):
    names = sorted(os.listdir(os.path.join(rd, "measurements")))
    frame_ids = [int(n.split(".")[0]) for n in names]
    ms = [ld.load_measurement(rd, i) for i in frame_ids]
    n = len(frame_ids)
    for i in range(0, n, sampling_rate):
      if i + PRED_LEN >= n:
        break                             # needs a full waypoint horizon
      if not ms[i].get("alive", True):
        continue
      s = ld.load_frame(rd, frame_ids[i], cfg)
      m = ms[i]
      p0 = np.asarray(m["pos_global"], np.float32)
      th0 = float(m["theta"])
      c, sn = np.cos(th0), np.sin(th0)
      rot = np.array([[c, sn], [-sn, c]], np.float32)
      wp = np.stack([
          rot @ (np.asarray(ms[i + k + 1]["pos_global"], np.float32) - p0)
          for k in range(PRED_LEN)])
      obj = np.zeros((max_objects, 8), np.float32)   # x y yaw ex ey v b cls
      valid = np.zeros((max_objects,), bool)
      for j, box in enumerate(s["boxes"][:max_objects]):
        if box["class"] == "ego_car":
          continue
        obj[j] = [box["position"][0], box["position"][1], box["yaw"],
                  box["extent"][0], box["extent"][1],
                  box.get("speed", 0.0), box.get("brake", 0.0),
                  CLASS_IDS.get(box["class"], 0)]
        valid[j] = True
      ckpt = np.asarray(m["route"], np.float32)[:tcfg.checkpoint_len]
      out.append(dict(
          rgb=s["rgb"].astype(np.float32) / 255.0,
          lidar_bev=s["lidar_bev"],
          semantic=s.get("semantic"),
          depth_norm=s.get("depth"),
          bev_semantic=s.get("bev_semantic"),
          speed=np.float32(m["speed"]),
          target_point=np.asarray(m["target_point"], np.float32),
          command=np.int32(m["command"]),
          speed_label=np.int32(_speed_class(cfg, m["target_speed"],
                                            m["brake"])),
          wp_label=wp, ckpt_label=ckpt,
          obj=obj, obj_valid=valid))
  return out


def make_disk_batch(cfg: GlobalConfig, tcfg: TransfuserConfig, samples, idx,
                    grid_hw, device="cuda") -> dict:
  """Stack host samples and move them to the device: the transfuser_loss
  batch dict."""
  dev = resolve_device(device)
  sel = [samples[i] for i in idx]
  st = lambda k: torch.from_numpy(np.stack([s[k] for s in sel])).to(dev)
  obj = st("obj")
  n = len(sel)
  batch = dict(
      rgb=st("rgb"), lidar_bev=st("lidar_bev"),
      speed=st("speed"), target_point=st("target_point"),
      command_onehot=command_onehot(st("command")),
      speed_label=st("speed_label"),
      wp_label=st("wp_label"), ckpt_label=st("ckpt_label"),
      obj_pos=obj[..., 0:2], obj_yaw=obj[..., 2],
      obj_extent=obj[..., 3:5], obj_speed=obj[..., 5],
      obj_brake=obj[..., 6], obj_cls=obj[..., 7].to(torch.int32),
      obj_valid=st("obj_valid"),
      # stored boxes are already ego-frame: identity transform
      ego_pos=torch.zeros((n, 2), device=dev),
      ego_yaw=torch.zeros((n,), device=dev),
      sample_w=torch.ones((n,), device=dev))
  if sel[0]["semantic"] is not None:
    # stored at the camera resolution the rig rendered (== model input res)
    batch["semantic"] = st("semantic").to(torch.int32)
    batch["depth_norm"] = st("depth_norm")
  if sel[0]["bev_semantic"] is not None:
    bev_ds = cfg.sensor.lidar_resolution_height // tcfg.lidar_h
    batch["bev_semantic_ds"] = st("bev_semantic")[
        :, ::bev_ds, ::bev_ds].to(torch.int32)
  batch["centernet"] = centernet_targets(cfg, tcfg, batch, grid_hw)
  return batch


def train_transfuser_from_disk(root: str, cfg: GlobalConfig,
                               tcfg: TransfuserConfig, steps: int = 1000,
                               batch_size: int = 8, lr: float = 3e-4,
                               sampling_rate: int = 1, seed: int = 0,
                               params: dict | None = None,
                               log_every: int = 50, device="cuda",
                               bf16: bool = False):
  """End to end: reference-layout dataset -> trained LidarCenterNet.

  params: a state dict to start from, or None for weights initialized from
  `seed`. The optimizer is the JAX package's plain chain, global-norm
  clipping at 1.0 then AdamW (weight decay 0.01 on every parameter, no
  schedule); batches are drawn with ``np.random.default_rng(seed)`` as
  JAX draws them. bf16: the forward and backward run on bfloat16 casts of
  the float32 parameters and inputs, as in-sim training does. Returns
  (model, history): the loss at every log_every-th step and the last."""
  dev = resolve_device(device)
  samples = load_disk_samples(root, cfg, tcfg, sampling_rate)
  if not samples:
    raise ValueError(f"no usable samples under {root}")
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(seed)
    model = LidarCenterNet(tcfg)
  if params is not None:
    model.load_state_dict(params)
  model = model.to(dev)
  opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=0.01)
  rng = np.random.default_rng(seed)
  grid_hw = (tcfg.lidar_h // 4, tcfg.lidar_w // 4)
  history = []
  for i in range(steps):
    idx = rng.choice(len(samples), size=min(batch_size, len(samples)),
                     replace=len(samples) < batch_size)
    batch = make_disk_batch(cfg, tcfg, samples, idx, grid_hw, dev)
    cast = None
    if bf16:
      cast = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
      for k in ("rgb", "lidar_bev"):
        batch[k] = batch[k].to(torch.bfloat16)
    opt.zero_grad(set_to_none=True)
    loss, aux = transfuser_loss(cfg, tcfg, model, cast, batch)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
    opt.step()
    if i % log_every == 0 or i == steps - 1:
      history.append({"step": i, "loss": float(aux["loss"].detach())})
  return model, history
