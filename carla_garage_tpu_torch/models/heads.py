"""Prediction heads (port of carla_garage_tpu/models/heads.py): perspective
decoder, CenterNet, the InterFuser-style GRU, sine position embedding and
the post-LN transformer-decoder join. Feature maps NCHW inside; outputs
are turned to NHWC by ``LidarCenterNet``."""

from __future__ import annotations

import math

import torch
from torch import nn

from carla_garage_tpu_torch.models.backbones import conv
from carla_garage_tpu_torch.models.fusion import (MultiHeadAttention,
                                                  upsample_bilinear)
from carla_garage_tpu_torch.models.layers import LayerNorm, Linear


class PerspectiveDecoder(nn.Module):
  """Two upsampling stages (x8 then x4) ending at a per-pixel map."""

  def __init__(self, in_channels: int, out_channels: int,
               inter_channel_0: int = 128, inter_channel_1: int = 64,
               inter_channel_2: int = 32, scale_factor_0: int = 8,
               scale_factor_1: int = 4):
    super().__init__()
    self.scale_factor_0 = scale_factor_0
    self.scale_factor_1 = scale_factor_1
    self.deconv1_0 = conv(in_channels, inter_channel_0, 3)
    self.deconv1_1 = conv(inter_channel_0, inter_channel_1, 3)
    self.deconv2_0 = conv(inter_channel_1, inter_channel_2, 3)
    self.deconv2_1 = conv(inter_channel_2, inter_channel_2, 3)
    self.deconv3_0 = conv(inter_channel_2, inter_channel_2, 3)
    self.deconv3_1 = conv(inter_channel_2, out_channels, 3)

  def forward(self, x):
    H, W = x.shape[-2:]
    h = torch.relu(self.deconv1_1(torch.relu(self.deconv1_0(x))))
    H1, W1 = H * self.scale_factor_0, W * self.scale_factor_0
    h = upsample_bilinear(h, (H1, W1))
    h = torch.relu(self.deconv2_1(torch.relu(self.deconv2_0(h))))
    h = upsample_bilinear(h, (H1 * self.scale_factor_1,
                              W1 * self.scale_factor_1))
    return self.deconv3_1(torch.relu(self.deconv3_0(h)))


class CenterNetHead(nn.Module):
  """Per-pixel detection heads over the BEV grid: heatmap, wh, offset,
  yaw class + residual, velocity, brake (each Conv3x3 + ReLU + Conv1x1)."""

  def __init__(self, channels: int, num_classes: int = 4,
               num_dir_bins: int = 12, with_velocity_brake: bool = True):
    super().__init__()
    self.outs = {"heatmap": num_classes, "wh": 2, "offset": 2,
                 "yaw_class": num_dir_bins, "yaw_res": 1}
    if with_velocity_brake:
      self.outs.update(velocity=1, brake=2)
    for name, n in self.outs.items():
      self.add_module(f"{name}_conv", conv(channels, channels, 3))
      self.add_module(f"{name}_out", conv(channels, n, 1))
    # heatmap prior p ~ 0.1 (center_net bias_init_with_prob)
    with torch.no_grad():
      self.heatmap_out.bias.fill_(-math.log((1 - 0.1) / 0.1))

  def forward(self, x):
    return {name: getattr(self, f"{name}_out")(
        torch.relu(getattr(self, f"{name}_conv")(x))) for name in self.outs}


class GRUCell(nn.Module):
  """flax GRUCell: r, z gates and candidate n; biases on ir, iz, in, hn.

  The flax ``in`` projection is ``in_`` here (``in`` is a Python keyword)."""

  def __init__(self, in_features: int, hidden: int):
    super().__init__()
    self.ir = Linear(in_features, hidden)
    self.iz = Linear(in_features, hidden)
    self.in_ = Linear(in_features, hidden)
    self.hr = Linear(hidden, hidden, bias=False)
    self.hz = Linear(hidden, hidden, bias=False)
    self.hn = Linear(hidden, hidden)

  def forward(self, h, x):
    r = torch.sigmoid(self.ir(x) + self.hr(h))
    z = torch.sigmoid(self.iz(x) + self.hz(h))
    n = torch.tanh(self.in_(x) + r * self.hn(h))
    return (1.0 - z) * n + z * h


class GRUWaypointsPredictorInterFuser(nn.Module):
  """GRU over query tokens with the target-point embedding as the initial
  hidden state, then per-step decode + cumsum. Runs in float32 even under
  a bf16 model (bf16-rounded weights, f32 math), as the JAX head does."""

  def __init__(self, in_features: int, pred_len: int, hidden_size: int = 64):
    super().__init__()
    self.pred_len = pred_len
    self.encoder = Linear(2, hidden_size)
    self.gru = GRUCell(in_features, hidden_size)
    self.decoder = Linear(hidden_size, 2)

  def forward(self, tokens, target_point):
    """tokens [B,T,C], target_point [B,2] -> [B,T,2] float32."""
    tokens = tokens.float()
    h = self.encoder(target_point.float())
    hs = []
    for t in range(tokens.shape[1]):
      h = self.gru(h, tokens[:, t])
      hs.append(h)
    deltas = self.decoder(torch.stack(hs, 1))
    return torch.cumsum(deltas, dim=1)


def sine_position_embedding(h: int, w: int, channels: int,
                            temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
  """2D sine positional encoding [h*w, channels], sin/cos interleaved."""
  n = channels // 2
  ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].repeat(
      1, w) + 1.0
  xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].repeat(
      h, 1) + 1.0
  ys = ys / (h + 1e-6) * 2 * math.pi
  xs = xs / (w + 1e-6) * 2 * math.pi
  dim_t = temperature ** (2 * (torch.arange(n, device=device) // 2) / n)
  py = ys[..., None] / dim_t
  px = xs[..., None] / dim_t
  py = torch.stack([torch.sin(py[..., 0::2]), torch.cos(py[..., 1::2])],
                   -1).reshape(h, w, -1)
  px = torch.stack([torch.sin(px[..., 0::2]), torch.cos(px[..., 1::2])],
                   -1).reshape(h, w, -1)
  return torch.cat([py, px], -1).reshape(h * w, channels)


class TransformerDecoderLayer(nn.Module):
  """Post-LN decoder layer (torch nn.TransformerDecoderLayer semantics,
  norm_first=False, dim_feedforward=2048, ReLU)."""

  def __init__(self, d_model: int, n_head: int, dim_ff: int = 2048):
    super().__init__()
    self.self_attn = MultiHeadAttention(d_model, n_head)
    self.ln1 = LayerNorm(d_model, eps=1e-5)
    self.cross_attn = MultiHeadAttention(d_model, n_head)
    self.ln2 = LayerNorm(d_model, eps=1e-5)
    self.ff1 = Linear(d_model, dim_ff)
    self.ff2 = Linear(dim_ff, d_model)
    self.ln3 = LayerNorm(d_model, eps=1e-5)

  def forward(self, tgt, memory):
    tgt = self.ln1(tgt + self.self_attn(tgt, tgt))
    tgt = self.ln2(tgt + self.cross_attn(tgt, memory))
    return self.ln3(tgt + self.ff2(torch.relu(self.ff1(tgt))))


class TransformerDecoderJoin(nn.Module):
  """Learned query tokens cross-attend into the fused BEV memory."""

  def __init__(self, d_model: int = 256, n_head: int = 8, n_layers: int = 6,
               num_queries: int = 11):
    super().__init__()
    self.queries = nn.Parameter(torch.randn(1, num_queries, d_model) * 0.02)
    self.n_layers = n_layers
    for i in range(n_layers):
      self.add_module(f"layer{i}", TransformerDecoderLayer(d_model, n_head))
    self.ln_f = LayerNorm(d_model, eps=1e-5)

  def forward(self, memory):
    tgt = self.queries.expand(memory.shape[0], -1, -1)
    for i in range(self.n_layers):
      tgt = getattr(self, f"layer{i}")(tgt, memory)
    return self.ln_f(tgt)
