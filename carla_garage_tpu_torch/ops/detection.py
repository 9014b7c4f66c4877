"""CenterNet training targets (port of the target half of
carla_garage_tpu/ops/detection.py): the gaussian radius, the max-composite
gaussian heatmap and the gaussian focal loss. The decode half
(``local_maximum``, ``topk_decode``, NMS) comes with the sensor agent's
stop-sign controller."""

from __future__ import annotations

import torch


def gaussian_radius(height, width, min_overlap=0.1):
  """Radius of the gaussian splat so IoU with the GT box stays above
  min_overlap (gaussian_target.py, three quadratic cases, take min)."""
  a1 = 1.0
  b1 = height + width
  c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
  sq1 = torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0.0))
  r1 = (b1 - sq1) / (2 * a1)
  a2 = 4.0
  b2 = 2 * (height + width)
  c2 = (1 - min_overlap) * width * height
  sq2 = torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0.0))
  r2 = (b2 - sq2) / (2 * a2)
  a3 = 4 * min_overlap
  b3 = -2 * min_overlap * (height + width)
  c3 = (min_overlap - 1) * width * height
  sq3 = torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))
  r3 = (b3 + sq3) / (2 * a3)
  return torch.minimum(torch.minimum(r1, r2), r3)


def splat_gaussian_heatmap(h: int, w: int, centers: torch.Tensor,
                           radii: torch.Tensor, valid: torch.Tensor,
                           cls: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
  """Max-composite gaussian targets [..,h,w,num_classes].

  centers [..,K,2] (x = col, y = row, float), radii [..,K], valid [..,K],
  cls [..,K]; leading axes (an episode batch) are kept. Each gaussian
  peaks at exactly 1.0 on floor(center), the integer pixel, as the
  reference splats (the offset head carries the fraction). The JAX
  package builds [K,h,w,C] and takes the max over K; here each class
  takes the max over its own boxes' [K,h,w] maps, which gives the same
  values without the one-hot axis."""
  dev = centers.device
  ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
  xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
  center = torch.floor(centers)[..., None, None, :]          # [..,K,1,1,2]
  sigma = torch.clamp((2 * radii + 1) / 6.0, min=1e-3)[..., None, None]
  g = torch.exp(-((xs - center[..., 0]) ** 2 + (ys - center[..., 1]) ** 2)
                / (2 * sigma ** 2))                          # [..,K,h,w]
  g = torch.where(valid[..., None, None], g, 0.0)
  cls = cls[..., None, None]
  return torch.stack([torch.where(cls == c, g, 0.0).amax(-3)
                      for c in range(num_classes)], -1)


def gaussian_focal_loss(pred_sigmoid, target, alpha=2.0, gamma=4.0):
  """CornerNet-style focal loss on gaussian heatmaps
  (transfuser_utils.py:341, mmdet gaussian_focal_loss)."""
  eps = 1e-12
  pos_w = (target >= 1.0 - 1e-4).to(torch.float32)
  neg_w = torch.pow(1 - target, gamma)
  pos = -torch.log(pred_sigmoid + eps) * torch.pow(
      1 - pred_sigmoid, alpha) * pos_w
  neg = -torch.log(1 - pred_sigmoid + eps) * torch.pow(
      pred_sigmoid, alpha) * neg_w * (1 - pos_w)
  return pos + neg
