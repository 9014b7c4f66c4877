"""Debug images, the model.visualize_model / TMP_VISU analog (port of
carla_garage_tpu/utils/visualization.py).

The reference renders composite debug frames (camera + BEV + predictions)
to disk during training and inference (model.py:647-836,
data_agent.py:235-236). Host-side equivalents here: BEV semantic frames,
camera panels and trajectory plots over the town raster, written as PNG
through ``utils/image_io``. Tensors are copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch

from carla_garage_tpu_torch.utils import image_io

# BGR->RGB of config.py:435-447 bev_classes_list
BEV_PALETTE = np.array([
    [0, 0, 0], [200, 200, 200], [255, 255, 255], [0, 255, 255],
    [157, 234, 50], [0, 160, 160], [0, 255, 0], [0, 255, 255],
    [0, 0, 255], [30, 170, 250], [0, 255, 0],
], np.uint8)


def _host(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def bev_to_rgb(bev) -> np.ndarray:
  """[H,W] class map -> [H,W,3] uint8."""
  return BEV_PALETTE[_host(bev)]


def save_png(path: str, img):
  """uint8 as it is; other types are taken in [0, 1] and scaled to 255."""
  img = _host(img)
  if img.dtype != np.uint8:
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
  image_io.write_png(path, img)


def plot_episode(path: str, town_raster, world_offset, ppm, route,
                 trajectory, infraction_points=None, title: str = ""):
  """Route vs driven trajectory over the town map (the result_parser
  infraction-map analog, tools/result_parser.py). Needs matplotlib."""
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  road = _host(town_raster)[0] > 0
  fig, ax = plt.subplots(figsize=(10, 10))
  ax.imshow(road, cmap="gray", origin="upper")

  def to_px(xy):
    return (_host(xy) - np.asarray(world_offset)) * ppm

  r = to_px(route)
  t = to_px(trajectory)
  ax.plot(r[:, 0], r[:, 1], "c-", lw=1.5, label="route")
  ax.plot(t[:, 0], t[:, 1], "m-", lw=1.0, label="driven")
  ax.plot(t[0, 0], t[0, 1], "go", ms=8, label="start")
  ax.plot(t[-1, 0], t[-1, 1], "rs", ms=8, label="end")
  if infraction_points is not None and len(infraction_points):
    p = to_px(infraction_points)
    ax.plot(p[:, 0], p[:, 1], "rx", ms=10, label="infractions")
  ax.legend()
  ax.set_title(title)
  ax.set_axis_off()
  fig.tight_layout()
  fig.savefig(path, dpi=120)
  plt.close(fig)


def camera_panel(path: str, rgb, semantic, depth, sem_palette):
  """Stacked camera debug panel: RGB / semantics / depth."""
  rgb8 = (np.clip(_host(rgb), 0, 1) * 255).astype(np.uint8)
  sem8 = (np.asarray(sem_palette)[_host(semantic)] * 255).astype(np.uint8)
  d = _host(depth)
  d8 = (np.clip(d / max(d.max(), 1e-3), 0, 1) * 255).astype(np.uint8)
  d8 = np.stack([d8] * 3, -1)
  save_png(path, np.concatenate([rgb8, sem8, d8], axis=0))
