"""CenterNet targets, decode and NMS (port of
carla_garage_tpu/ops/detection.py): the gaussian radius, the
max-composite gaussian heatmap and the gaussian focal loss for training;
``local_maximum``, ``topk_decode``, ``rotated_iou_approx`` and
``nms_rotated`` for the sensor agent's stop-sign controller.

Ties order as in the JAX package: ``topk_decode`` ranks equal peaks by
their flat index, lower first (``jax.lax.top_k``), and ``nms_rotated``
visits equal scores in slot order (a stable sort, as ``jnp.argsort``);
``torch.topk`` promises neither."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.cgt.sim import geometry as geo


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


def local_maximum(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
  """Keep only the 3x3 local maxima of [B,h,w,C] maps, zero elsewhere
  (center_net.get_local_maximum); the window is padded with -inf."""
  pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, stride=1,
                        padding=kernel // 2).permute(0, 2, 3, 1)
  return torch.where(pooled == heat, heat, 0.0)


def topk_decode(preds: dict, *, ppm: float, k: int = 100,
                min_x: float = -32.0, min_y: float = -32.0,
                num_dir_bins: int = 12) -> dict:
  """The k best boxes of CenterNet outputs (center_net.py:172-237 +
  model.convert_features_to_bb_metric :447-459).

  preds: dict of [B,h,w,*] raw logits. ppm: grid cells per metre of the
  detection grid. Returns dict of [B,k] tensors: x, y (metres, ego
  frame), w, l, yaw, velocity, brake (int32), score, cls (int32)."""
  heat = local_maximum(torch.sigmoid(preds["heatmap"]))
  B, h, w, C = heat.shape
  # a stable descending sort: equal scores keep the lower index first
  score, idx = torch.sort(heat.reshape(B, -1), dim=-1, descending=True,
                          stable=True)
  score, idx = score[:, :k], idx[:, :k]
  cls = idx % C
  pix = idx // C
  py = (pix // w).to(torch.float32)
  px = (pix % w).to(torch.float32)

  def gather(m):
    flat = m.reshape(B, h * w, -1)
    return torch.gather(flat, 1, pix[..., None].expand(-1, -1,
                                                       flat.shape[-1]))

  off = gather(preds["offset"])
  wh = gather(preds["wh"])
  yaw_cls = torch.argmax(gather(preds["yaw_class"]), -1)
  yaw_res = gather(preds["yaw_res"])[..., 0]
  # velocity and brake branches are absent on pretrained drop-ins
  vel = gather(preds["velocity"])[..., 0] if "velocity" in preds \
      else torch.zeros_like(yaw_res)
  brake = torch.argmax(gather(preds["brake"]), -1) if "brake" in preds \
      else torch.zeros_like(yaw_cls)
  cx = px + off[..., 0]
  cy = py + off[..., 1]
  yaw = geo.normalize_angle(yaw_cls * (2 * math.pi / num_dir_bins) +
                            yaw_res)
  return {
      "x": cx / ppm + min_x, "y": cy / ppm + min_y,
      "w": wh[..., 0] / ppm, "l": wh[..., 1] / ppm,
      "yaw": yaw, "velocity": vel, "brake": brake.to(torch.int32),
      "score": score, "cls": cls.to(torch.int32),
  }


def rotated_iou_approx(c1, y1, e1, c2, y2, e2, n_samples: int = 8):
  """Approximate rotated-box IoU: the share of an n x n grid of points in
  box 1 that falls in box 2, times box 1's area, over the union."""
  lin = (torch.arange(n_samples, dtype=torch.float32, device=c1.device)
         + 0.5) / n_samples * 2.0 - 1.0
  gy, gx = torch.meshgrid(lin, lin, indexing="ij")
  local = torch.stack([gx, gy], -1).reshape(-1, 2)       # [S,2] in [-1,1]
  pts = geo.ego_to_world(local * e1[..., None, :], c1[..., None, :],
                         y1[..., None])
  inside = geo.point_in_obb(pts, c2[..., None, :], y2[..., None],
                            e2[..., None, :])
  inter_frac = torch.mean(inside.to(torch.float32), -1)
  a1 = 4 * e1[..., 0] * e1[..., 1]
  a2 = 4 * e2[..., 0] * e2[..., 1]
  inter = inter_frac * a1
  return inter / torch.clamp(a1 + a2 - inter, min=1e-6)


def nms_rotated(boxes: dict, iou_threshold: float = 0.2,
                score_threshold: float = 0.3) -> torch.Tensor:
  """Greedy rotated NMS over decoded boxes [B,K] -> keep mask [B,K]."""
  c = torch.stack([boxes["x"], boxes["y"]], -1)           # [B,K,2]
  e = torch.stack([boxes["l"], boxes["w"]], -1) / 2.0
  yaw = boxes["yaw"]
  score = boxes["score"]
  B, K = score.shape
  iou = rotated_iou_approx(c[:, :, None], yaw[:, :, None], e[:, :, None],
                           c[:, None], yaw[:, None], e[:, None])  # [B,K,K]
  # the sampled IoU is asymmetric: symmetrize, so that a low-scoring
  # survivor never suppresses a higher-scoring kept box
  iou = torch.maximum(iou, iou.transpose(-1, -2))
  order = torch.argsort(-score, dim=-1, stable=True)
  rows = torch.arange(B, device=score.device)
  keep = score > score_threshold
  for i in range(K):
    # suppress the boxes overlapping the i-th highest-scoring kept box
    bi = order[:, i]
    is_kept = keep[rows, bi]
    row = iou[rows, bi]                                   # [B,K]
    suppress = (row > iou_threshold) & is_kept[:, None]
    suppress[rows, bi] = False
    keep = keep & ~suppress
  return keep
