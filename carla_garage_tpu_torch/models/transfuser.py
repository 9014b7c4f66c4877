"""TransFuser++ — dual-branch sensor fusion + planning heads (port of
carla_garage_tpu/models/transfuser.py).

RegNetY image + LiDAR branches exchanged 4x through GPT fusion, a
top-down path to the BEV grid, a transformer-decoder join producing the
checkpoint / target-speed queries, and the auxiliary heads (perspective
semantics + depth, BEV semantics, CenterNet detection). Inputs and outputs
are NHWC like the JAX model's; the convolutions run NCHW inside.

With ``lidar_arch="video_swin_t"`` (a ``VideoTransfuserConfig``, beyond
the JAX package) the LiDAR branch is the published Video Swin over
``lidar_seq_len`` frames in place of the RegNetY stem and stages. Each
fusion takes the Swin stage's time mean and its LiDAR residual is added
back at every time step before the next stage; the stride-32 map is the
time mean after the last fusion. The Swin stages run inside the span
``model.lidar_video``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from carla_garage_tpu_torch.device import const
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
from carla_garage_tpu_torch.models.video_nets import VideoSwin
from carla_garage_tpu_torch.utils.profiling import span

VIDEO_SWIN = "video_swin_t"     # the lidar_arch of the Video Swin branch


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


@dataclasses.dataclass(frozen=True)
class VideoTransfuserConfig(TransfuserConfig):
  """A TransfuserConfig with a temporal LiDAR branch: lidar_seq_len frames
  of lidar_channels each (the LiDAR input [B,H,W,lidar_channels *
  lidar_seq_len] holds them newest first, as the sensor agent's buffer
  voxelizes them), encoded by the published Video Swin at the swin_*
  sizes (Video Swin-T's by default; the patch and MLP ratio are the
  published block's own). A class of its own: the JAX
  package's TransfuserConfig, which checkpoints' meta and the parity tests
  compare field for field, has none of these fields."""
  lidar_arch: str = "video_swin_t"
  lidar_seq_len: int = 16
  swin_embed_dim: int = 96
  swin_depths: tuple = (2, 2, 6, 2)
  swin_heads: tuple = (3, 6, 12, 24)
  swin_window: tuple = (8, 7, 7)


def lidar_widths(c: TransfuserConfig) -> tuple:
  """The LiDAR branch's 4 stage widths."""
  if c.lidar_arch != VIDEO_SWIN:
    return tuple(arch_spec(c.lidar_arch)["widths"])
  if not isinstance(c, VideoTransfuserConfig):
    raise ValueError(f"lidar_arch {c.lidar_arch} takes a "
                     "VideoTransfuserConfig")
  return tuple(c.swin_embed_dim * 2 ** i for i in range(4))


def lidar_history(c: TransfuserConfig) -> int:
  """The half sweeps a sensor agent keeps for this model
  (``sensor_agent_reset(..., seq_len=)``): ``lidar_seq_len`` for a video
  branch, else one a channel pair of the LiDAR input."""
  if c.lidar_arch == VIDEO_SWIN:
    return c.lidar_seq_len
  return max(c.lidar_channels // 2, 1)


def video_frames(lidar_bev: torch.Tensor, c: TransfuserConfig
                 ) -> torch.Tensor:
  """The LiDAR input's channel groups as frames: [B, lidar_seq_len *
  lidar_channels, H, W], newest first -> [B, lidar_channels,
  lidar_seq_len, H, W], oldest first."""
  B, CK, H, W = lidar_bev.shape
  if CK != c.lidar_channels * c.lidar_seq_len:
    raise ValueError(
        f"the LiDAR input has {CK} channels, the video branch takes "
        f"{c.lidar_channels} for each of {c.lidar_seq_len} frames: reset "
        "the sensor agent with seq_len=lidar_history(config)")
  x = lidar_bev.reshape(B, c.lidar_seq_len, c.lidar_channels, H, W)
  return x.flip(1).transpose(1, 2)


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
  res / 4, fused LiDAR features at stride 32). norm: the branches' norm
  (``backbones.make_norm``)."""

  def __init__(self, c: TransfuserConfig, norm: str = "gn"):
    super().__init__()
    self.cfg = c
    self.video = c.lidar_arch == VIDEO_SWIN
    ispec, widths = arch_spec(c.image_arch), lidar_widths(c)
    self.image_stem = RegNetYStem(3, ispec["stem_w"], norm)
    if self.video:
      self.lidar_video = VideoSwin(
          c.swin_embed_dim, c.swin_depths, c.swin_heads, c.swin_window,
          c.lidar_channels, (c.lidar_seq_len, c.lidar_h, c.lidar_w))
    else:
      lspec = arch_spec(c.lidar_arch)
      self.lidar_stem = RegNetYStem(c.lidar_channels, lspec["stem_w"], norm)
      wl = lspec["stem_w"]
    wi = ispec["stem_w"]
    for i in range(4):
      self.add_module(f"image_stage{i}", RegNetYStage(
          wi, ispec["depths"][i], ispec["widths"][i], ispec["group_w"],
          ispec["se_ratio"], norm))
      if not self.video:
        self.add_module(f"lidar_stage{i}", RegNetYStage(
            wl, lspec["depths"][i], widths[i], lspec["group_w"],
            lspec["se_ratio"], norm))
      wi, wl = ispec["widths"][i], widths[i]
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
      # cached on the device: no copy from the host inside a CUDA graph
      mean = const([0.485, 0.456, 0.406], rgb.device, rgb.dtype)
      std = const([0.229, 0.224, 0.225], rgb.device, rgb.dtype)
      rgb = (rgb / 255.0 - mean[:, None, None]) / std[:, None, None]
    img = self.image_stem(rgb)
    if self.video:
      img, lid = self._video_stages(img, lidar_bev)
    else:
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

  def _video_stages(self, img, lidar_bev):
    """The image stages and the Swin stages with the fusion between them:
    each fusion sees the stage's time mean, and its LiDAR residual goes
    back into every frame. Returns (image map, the LiDAR time mean after
    the last fusion), NCHW."""
    swin = self.lidar_video
    with span("model.lidar_video"):
      h = swin.embed(video_frames(lidar_bev, self.cfg))
    for i in range(4):
      img = getattr(self, f"image_stage{i}")(img)
      with span("model.lidar_video"):
        if i > 0:
          h = h + lid_up.permute(0, 2, 3, 1)[:, None]
        h = swin.stage(i, h)
        mean = h.mean(1).permute(0, 3, 1, 2)
      img_up, lid_up = getattr(self, f"fusion{i}").residuals(img, mean)
      img = img + img_up
    return img, mean + lid_up


def _nhwc(x):
  return x.permute(0, 2, 3, 1)


class LidarCenterNet(nn.Module):
  """Umbrella driving model: backbone + planning + auxiliary heads.

  forward(rgb [B,H,W,3], lidar_bev [B,H,W,C], target_point [B,2],
  command_onehot [B,6], velocity [B]) -> dict of outputs, NHWC maps.
  norm="bn_affine" builds the backbone with folded BatchNorms, the layout
  a converted reference checkpoint loads into (``convert.assemble``)."""

  def __init__(self, c: TransfuserConfig, norm: str = "gn"):
    super().__init__()
    self.cfg = c
    ispec = arch_spec(c.image_arch)
    self.backbone = TransfuserBackbone(c, norm)
    self.change_channel = conv(lidar_widths(c)[-1], c.d_model, 1)
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
    if c.use_wp_gru:
      # waypoints: a decoder of their own over the same memory, with
      # pred_len queries, then a GRU with the target point as its initial
      # hidden state (model.py:151-175)
      self.join_wp = TransformerDecoderJoin(c.d_model, c.n_decoder_heads,
                                            c.n_decoder_layers,
                                            num_queries=c.pred_len)
      self.wp_decoder = GRUWaypointsPredictorInterFuser(
          c.d_model, c.pred_len, c.gru_hidden)
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
    if c.use_wp_gru:
      out["pred_wp"] = self.wp_decoder(self.join_wp(mem), target_point)
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
