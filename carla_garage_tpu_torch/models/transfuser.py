"""TransFuser++ — dual-branch sensor fusion + planning heads (port of
carla_garage_tpu/models/transfuser.py).

RegNetY image + LiDAR branches exchanged 4x through GPT fusion, a
top-down path to the BEV grid, a transformer-decoder join producing the
checkpoint / target-speed queries, and the auxiliary heads (perspective
semantics + depth, BEV semantics, CenterNet detection). Inputs and outputs
are NHWC like the JAX model's; the convolutions run NCHW inside.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from carla_garage_tpu_torch.models.backbones import (AffineNorm,
                                                     RegNetYStage,
                                                     RegNetYStem, arch_spec,
                                                     conv)
from carla_garage_tpu_torch.models.fusion import (FusionStage,
                                                  upsample_bilinear)
from carla_garage_tpu_torch.models.layers import Linear
from carla_garage_tpu_torch.models.heads import (
    CenterNetHead, GRUWaypointsPredictorInterFuser, PerspectiveDecoder,
    TransformerDecoderJoin, sine_position_embedding)


@dataclasses.dataclass(frozen=True)
class TransfuserConfig:
  """The model-relevant subset of the reference GlobalConfig."""
  image_arch: str = "regnety_032"
  lidar_arch: str = "regnety_032"
  img_h: int = 256
  img_w: int = 1024
  lidar_h: int = 256
  lidar_w: int = 256
  lidar_channels: int = 2
  n_embd: int = 256
  n_head: int = 4
  n_fusion_layers: int = 2
  img_anchors: tuple = (8, 32)
  lidar_anchors: tuple = (8, 8)
  bev_features_channels: int = 64
  d_model: int = 256
  n_decoder_heads: int = 8
  n_decoder_layers: int = 6
  pred_len: int = 8
  checkpoint_len: int = 10
  num_route_points: int = 20
  gru_hidden: int = 64
  num_semantic: int = 7
  num_bev_semantic: int = 11
  num_bb_classes: int = 4
  num_dir_bins: int = 12
  target_speed_bins: int = 4
  bb_velocity_brake: bool = True
  use_wp_gru: bool = False
  normalize_imagenet: bool = False
  use_controller_input_prediction: bool = True
  use_velocity: bool = True
  use_semantic: bool = True
  use_depth: bool = True
  use_bev_semantic: bool = True
  detect_boxes: bool = True


def micro_config() -> TransfuserConfig:
  """Small config for tests."""
  return TransfuserConfig(image_arch="regnety_micro",
                          lidar_arch="regnety_micro",
                          img_h=64, img_w=128, lidar_h=64, lidar_w=64,
                          n_embd=64, d_model=64, n_decoder_layers=2,
                          img_anchors=(2, 4), lidar_anchors=(2, 2))


class TransfuserBackbone(nn.Module):
  """Dual RegNetY branches with per-stage GPT fusion plus the top-down BEV
  path. Returns NCHW (image features at stride 32, BEV grid at lidar
  res / 4, fused LiDAR features at stride 32)."""

  def __init__(self, c: TransfuserConfig):
    super().__init__()
    self.cfg = c
    ispec, lspec = arch_spec(c.image_arch), arch_spec(c.lidar_arch)
    self.image_stem = RegNetYStem(3, ispec["stem_w"])
    self.lidar_stem = RegNetYStem(c.lidar_channels, lspec["stem_w"])
    wi, wl = ispec["stem_w"], lspec["stem_w"]
    for i in range(4):
      self.add_module(f"image_stage{i}", RegNetYStage(
          wi, ispec["depths"][i], ispec["widths"][i], ispec["group_w"],
          ispec["se_ratio"]))
      self.add_module(f"lidar_stage{i}", RegNetYStage(
          wl, lspec["depths"][i], lspec["widths"][i], lspec["group_w"],
          lspec["se_ratio"]))
      wi, wl = ispec["widths"][i], lspec["widths"][i]
      self.add_module(f"fusion{i}", FusionStage(
          wi, wl, c.img_anchors, c.lidar_anchors, c.n_head,
          c.n_fusion_layers))
    ch = c.bev_features_channels
    self.c5_conv = conv(wl, ch, 1)
    self.up_conv5 = conv(ch, ch, 3)
    self.up_conv4 = conv(ch, ch, 3)

  def forward(self, rgb, lidar_bev):
    c = self.cfg
    if c.normalize_imagenet:
      mean = torch.tensor([0.485, 0.456, 0.406], dtype=rgb.dtype,
                          device=rgb.device)[:, None, None]
      std = torch.tensor([0.229, 0.224, 0.225], dtype=rgb.dtype,
                         device=rgb.device)[:, None, None]
      rgb = (rgb / 255.0 - mean) / std
    img = self.image_stem(rgb)
    lid = self.lidar_stem(lidar_bev)
    for i in range(4):
      img = getattr(self, f"image_stage{i}")(img)
      lid = getattr(self, f"lidar_stage{i}")(lid)
      img, lid = getattr(self, f"fusion{i}")(img, lid)
    Hl32, Wl32 = lid.shape[-2:]
    p5 = torch.relu(self.c5_conv(lid))
    p4 = torch.relu(self.up_conv5(upsample_bilinear(p5, (Hl32 * 2,
                                                         Wl32 * 2))))
    p4u = upsample_bilinear(p4, (c.lidar_h // 4, c.lidar_w // 4))
    bev_grid = torch.relu(self.up_conv4(p4u))
    return img, bev_grid, lid


def _nhwc(x):
  return x.permute(0, 2, 3, 1)


class LidarCenterNet(nn.Module):
  """Umbrella driving model: backbone + planning + auxiliary heads.

  forward(rgb [B,H,W,3], lidar_bev [B,H,W,C], target_point [B,2],
  command_onehot [B,6], velocity [B]) -> dict of outputs, NHWC maps."""

  def __init__(self, c: TransfuserConfig):
    super().__init__()
    if c.use_wp_gru:
      raise NotImplementedError("use_wp_gru is not ported yet")
    self.cfg = c
    lspec = arch_spec(c.lidar_arch)
    ispec = arch_spec(c.image_arch)
    self.backbone = TransfuserBackbone(c)
    self.change_channel = conv(lspec["widths"][-1], c.d_model, 1)
    self.velocity_norm = AffineNorm(1)
    self.extra_fc1 = Linear(7, 128)
    self.extra_fc2 = Linear(128, c.d_model)
    self.extra_sensor_pos_embed = nn.Parameter(torch.zeros(1, c.d_model))
    self.join = TransformerDecoderJoin(c.d_model, c.n_decoder_heads,
                                       c.n_decoder_layers,
                                       num_queries=c.checkpoint_len + 1)
    self.checkpoint_decoder = GRUWaypointsPredictorInterFuser(
        c.d_model, c.checkpoint_len, c.gru_hidden)
    self.target_speed_fc1 = Linear(c.d_model, c.d_model)
    self.target_speed_head = Linear(c.d_model, c.target_speed_bins)
    cimg = ispec["widths"][-1]
    if c.use_semantic:
      self.semantic_decoder = PerspectiveDecoder(cimg, c.num_semantic)
    if c.use_depth:
      self.depth_decoder = PerspectiveDecoder(cimg, 1)
    cb = c.bev_features_channels
    if c.use_bev_semantic:
      self.bev_semantic_conv = conv(cb, cb, 3)
      self.bev_semantic_head = conv(cb, c.num_bev_semantic, 1)
    if c.detect_boxes:
      self.centernet = CenterNetHead(cb, c.num_bb_classes, c.num_dir_bins,
                                     c.bb_velocity_brake)

  def forward(self, rgb, lidar_bev, target_point, command_onehot,
              velocity) -> Dict[str, Any]:
    c = self.cfg
    img_feat, bev_grid, fused = self.backbone(
        rgb.permute(0, 3, 1, 2), lidar_bev.permute(0, 3, 1, 2))
    B = bev_grid.shape[0]
    Hf, Wf = fused.shape[-2:]
    mem = self.change_channel(fused).flatten(2).transpose(1, 2)
    # the f32 embedding promotes the memory to f32, as in the JAX model
    mem = mem + sine_position_embedding(Hf, Wf, c.d_model,
                                        device=mem.device)[None]
    vel_n = self.velocity_norm(velocity[:, None])
    extra_in = torch.cat([vel_n, command_onehot], -1)
    extra = torch.relu(self.extra_fc1(extra_in))
    extra = torch.relu(self.extra_fc2(extra))
    extra = extra + self.extra_sensor_pos_embed
    mem = torch.cat([mem, extra[:, None].to(mem.dtype)], 1)
    q = self.join(mem)
    checkpoint_tokens, speed_token = q[:, :-1], q[:, -1]

    out: Dict[str, Any] = {}
    out["pred_checkpoint"] = self.checkpoint_decoder(checkpoint_tokens,
                                                     target_point)
    ts_h = torch.relu(self.target_speed_fc1(speed_token))
    out["pred_target_speed"] = self.target_speed_head(ts_h)
    if c.use_semantic:
      out["pred_semantic"] = _nhwc(self.semantic_decoder(img_feat))
    if c.use_depth:
      out["pred_depth"] = torch.sigmoid(self.depth_decoder(img_feat)[:, 0])
    if c.use_bev_semantic:
      h = torch.relu(self.bev_semantic_conv(bev_grid))
      h = self.bev_semantic_head(h)
      out["pred_bev_semantic"] = _nhwc(upsample_bilinear(
          h, (c.lidar_h, c.lidar_w)))
    if c.detect_boxes:
      out["pred_bb"] = {k: _nhwc(v)
                        for k, v in self.centernet(bev_grid).items()}
    return out
