"""GPT-style sensor-fusion transformer (port of carla_garage_tpu/models/fusion.py).

Attention is plain matmul + softmax with flax's MultiHeadDotProductAttention
layout: query/key/value projections [in] -> [heads, head_dim] with bias,
the query scaled by 1/sqrt(head_dim), and an output projection from
[heads, head_dim].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from carla_garage_tpu_torch.models.backbones import conv
from carla_garage_tpu_torch.models.layers import LayerNorm, Linear


def upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
  """``jax.image.resize(..., "bilinear")`` for the upsampling (or identity)
  resizes the model does: half-pixel centers, edge-clamped, no
  antialiasing. x NCHW."""
  if tuple(x.shape[-2:]) == tuple(size):
    return x
  return F.interpolate(x, size=tuple(size), mode="bilinear",
                       align_corners=False, antialias=False)


class MultiHeadAttention(nn.Module):
  """flax MultiHeadDotProductAttention (no dropout, no mask)."""

  def __init__(self, in_features: int, num_heads: int,
               qkv_features: int | None = None,
               out_features: int | None = None):
    super().__init__()
    qkv = qkv_features or in_features
    self.num_heads = num_heads
    self.head_dim = qkv // num_heads
    self.query = Linear(in_features, qkv)
    self.key = Linear(in_features, qkv)
    self.value = Linear(in_features, qkv)
    self.out = Linear(qkv, out_features or in_features)

  def forward(self, x_q, x_kv):
    B, Lq, _ = x_q.shape
    Lk = x_kv.shape[1]
    H, hd = self.num_heads, self.head_dim
    q = self.query(x_q).reshape(B, Lq, H, hd)
    k = self.key(x_kv).reshape(B, Lk, H, hd)
    v = self.value(x_kv).reshape(B, Lk, H, hd)
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = q.to(dt) / math.sqrt(hd), k.to(dt), v.to(dt)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Lq, H * hd)
    return self.out(o)


class SelfAttentionBlock(nn.Module):
  """x + attn(ln1(x)); x + mlp(ln2(x)); ReLU MLP."""

  def __init__(self, n_embd: int, n_head: int, block_exp: int = 4):
    super().__init__()
    self.ln1 = LayerNorm(n_embd, eps=1e-5)
    self.attn = MultiHeadAttention(n_embd, n_head, qkv_features=n_embd)
    self.ln2 = LayerNorm(n_embd, eps=1e-5)
    self.mlp_fc = Linear(n_embd, block_exp * n_embd)
    self.mlp_proj = Linear(block_exp * n_embd, n_embd)

  def forward(self, x):
    h = self.ln1(x)
    x = x + self.attn(h, h)
    h = self.mlp_proj(torch.relu(self.mlp_fc(self.ln2(x))))
    return x + h


class GPTFusion(nn.Module):
  """Joint self-attention over [img tokens ; lidar tokens]."""

  def __init__(self, n_embd: int, n_tokens: int, n_head: int = 4,
               n_layer: int = 2, block_exp: int = 4):
    super().__init__()
    self.pos_emb = nn.Parameter(torch.randn(1, n_tokens, n_embd) * 0.02)
    for i in range(n_layer):
      self.add_module(f"block{i}", SelfAttentionBlock(n_embd, n_head,
                                                      block_exp))
    self.n_layer = n_layer
    self.ln_f = LayerNorm(n_embd, eps=1e-5)

  def forward(self, img_tokens, lidar_tokens):
    n_img = img_tokens.shape[1]
    x = torch.cat([img_tokens, lidar_tokens], dim=1) + self.pos_emb
    for i in range(self.n_layer):
      x = getattr(self, f"block{i}")(x)
    x = self.ln_f(x)
    return x[:, :n_img], x[:, n_img:]


class FusionStage(nn.Module):
  """One of the 4 TransFuser fusion exchanges: pool -> lidar_to_img 1x1 ->
  GPT at the image stage width -> img_to_lidar 1x1 -> bilinear upsample ->
  residual add. Feature maps NCHW."""

  def __init__(self, c_img: int, c_lidar: int, img_anchors, lidar_anchors,
               n_head: int = 4, n_layer: int = 2):
    super().__init__()
    self.img_anchors = tuple(img_anchors)
    self.lidar_anchors = tuple(lidar_anchors)
    ih, iw = self.img_anchors
    lh, lw = self.lidar_anchors
    self.lidar_to_img = conv(c_lidar, c_img, 1)
    self.gpt = GPTFusion(c_img, ih * iw + lh * lw, n_head, n_layer)
    self.img_to_lidar = conv(c_img, c_lidar, 1)

  @staticmethod
  def _pool_to(x, oh, ow):
    # adaptive average pool via reshape-mean (sizes divide evenly here)
    B, C, H, W = x.shape
    return x.reshape(B, C, oh, H // oh, ow, W // ow).mean((3, 5))

  def forward(self, img_feat, lidar_feat):
    B, Ci, Hi, Wi = img_feat.shape
    _, Cl, Hl, Wl = lidar_feat.shape
    ih, iw = self.img_anchors
    lh, lw = self.lidar_anchors
    img_t = self._pool_to(img_feat, ih, iw)
    lid_t = self.lidar_to_img(self._pool_to(lidar_feat, lh, lw))
    img_tok, lid_tok = self.gpt(img_t.flatten(2).transpose(1, 2),
                                lid_t.flatten(2).transpose(1, 2))
    img_up = img_tok.transpose(1, 2).reshape(B, Ci, ih, iw)
    lid_up = self.img_to_lidar(lid_tok.transpose(1, 2).reshape(B, Ci, lh, lw))
    img_up = upsample_bilinear(img_up, (Hi, Wi))
    lid_up = upsample_bilinear(lid_up, (Hl, Wl))
    return img_feat + img_up, lidar_feat + lid_up
