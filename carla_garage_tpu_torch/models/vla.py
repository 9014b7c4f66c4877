"""SimLingo: a camera-only vision-language-action driving model (Renz et
al., "SimLingo: Vision-Only Closed-Loop Autonomous Driving with
Language-Action Alignment", CVPR 2025, arXiv:2503.09594) on InternVL2-1B,
in its driving mode: one forward a tick, no decoding.

- Vision: InternViT-300M-448px over each 448x448 tile of the camera frame
  (``agents.sensor_agent.camera_tiles``: the frame's tiles, then its
  thumbnail). A 14x14 patch embedding, a class token and a learned
  position embedding, then pre-norm blocks ``x = x + ls1 * Attn(LN1(x))``,
  ``x = x + ls2 * MLP(LN2(x))`` with LayerScale, bidirectional attention
  and an exact-GELU MLP; the last block's states, without a final norm.
  The blocks' residual stream is kept in float32 whatever the parameters'
  dtype: LayerScale makes each update a small part of the stream, below
  bf16's resolution of it (in bf16 the driving outputs drift by 2-3x more
  from the float32 model's). The norms, matmuls and attention run in the
  parameters' dtype.
- Projector: the class token dropped, InternVL's ``pixel_shuffle`` (scale
  0.5, ``ps_version`` v2) to a quarter of the tokens at four times the
  width, then LayerNorm, Linear, GELU, Linear into the decoder's width.
- Decoder: Qwen2-0.5B. Pre-norm layers with RMSNorm (computed in float32
  and cast to the parameters' dtype), rotary positions (rotate-half,
  theta 1e6), causal grouped-query attention (14 query heads share 2
  key-value heads) and a SwiGLU MLP; a final RMSNorm. The language-model
  head is never used. As in the vision tower, the layers' residual stream
  is float32 (in bf16 the driving outputs' worst drift from the float32
  model's is about a quarter larger); each update is added in float32.
- Driving glue: a fixed prompt template of token ids with the command's
  id last, the image tokens spliced in after its first ``image_at`` ids,
  then two target-point tokens and a speed token (each a small MLP), and
  learned queries last: ``path_points`` path points 1 m apart and
  ``speed_points`` speed waypoints at 4 Hz, each read out by a linear
  layer into the ego frame.

``forward(tiles [B,T,3,S,S], target_points [B,2,2], speed [B], command
[B,6] one-hot) -> {"pred_path": [B,P,2], "pred_wp": [B,W,2]}``. The
vision tower through the projector runs inside the span ``model.vision``
(counting the tiles) and the splice through the read-outs inside
``model.language`` (counting the tokens).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from carla_garage_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SimLingoConfig:
  """The published InternVL2-1B widths (InternViT-300M-448px, its
  projector, Qwen2-0.5B-Instruct) and the driving glue's sizes."""
  # the camera and InternVL2's tiling of it
  camera_width: int = 896
  camera_height: int = 448
  camera_fov: float = 110.0
  tile: int = 448
  # InternViT-300M-448px
  patch: int = 14
  vit_hidden: int = 1024
  vit_layers: int = 24
  vit_heads: int = 16
  vit_mlp: int = 4096
  vit_eps: float = 1e-6
  # the projector (mlp1)
  proj_eps: float = 1e-5
  # Qwen2-0.5B
  hidden: int = 896
  layers: int = 24
  heads: int = 14
  kv_heads: int = 2
  mlp: int = 4864
  vocab: int = 151936
  regular_ids: int = 151643     # the tokenizer's ids below its specials
  rms_eps: float = 1e-6
  rope_theta: float = 1e6
  # the driving glue
  template_len: int = 40
  image_at: int = 8
  template_seed: int = 0
  path_points: int = 20
  speed_points: int = 8

  @property
  def grid(self) -> tuple:
    """(columns, rows) of tiles the frame splits into."""
    return self.camera_width // self.tile, self.camera_height // self.tile

  @property
  def n_tiles(self) -> int:
    """The frame's tiles, and its thumbnail where there is more than one."""
    n = self.grid[0] * self.grid[1]
    return n + 1 if n > 1 else n

  @property
  def tokens_per_tile(self) -> int:
    return (self.tile // self.patch // 2) ** 2

  @property
  def seq_len(self) -> int:
    return (self.template_len + self.n_tiles * self.tokens_per_tile + 3
            + self.path_points + self.speed_points)


def prompt_ids(c: SimLingoConfig) -> tuple:
  """(template [template_len], command ids [6]): token ids drawn once
  from ``template_seed`` among the tokenizer's regular ids; the template's
  last id is replaced by the command's."""
  ids = np.random.default_rng(c.template_seed).integers(
      0, c.regular_ids, c.template_len + 6)
  return (torch.as_tensor(ids[:c.template_len]),
          torch.as_tensor(ids[c.template_len:]))


def pixel_shuffle(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
  """InternVL's ``pixel_shuffle`` (``ps_version`` v2): [n, w, h, c] ->
  [n, w * scale, h * scale, c / scale**2]."""
  n, w, h, c = x.shape
  x = x.view(n, w, int(h * scale), int(c / scale))
  x = x.permute(0, 2, 1, 3).contiguous()
  x = x.view(n, int(h * scale), int(w * scale), int(c / (scale * scale)))
  return x.permute(0, 2, 1, 3).contiguous()


def rope_cos_sin(n: int, dim: int, theta: float, device, dtype):
  """cos and sin [n, dim] of positions 0..n-1 (rotate-half layout),
  computed in float32 and cast to `dtype`."""
  inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device,
                                     dtype=torch.float32) / dim)
  freqs = torch.outer(torch.arange(n, device=device, dtype=torch.float32),
                      inv)
  emb = torch.cat([freqs, freqs], -1)
  return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
  h = x.shape[-1] // 2
  return torch.cat([-x[..., h:], x[..., :h]], -1)


def apply_rope(x, cos, sin):
  """x [B, heads, L, D] at positions 0..L-1."""
  return x * cos + rotate_half(x) * sin


# --- InternViT ----------------------------------------------------------------

class VisionEmbeddings(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    n = (c.tile // c.patch) ** 2
    self.class_embedding = nn.Parameter(torch.zeros(1, 1, c.vit_hidden))
    self.patch_embedding = nn.Conv2d(3, c.vit_hidden, c.patch, c.patch)
    self.position_embedding = nn.Parameter(torch.zeros(1, n + 1,
                                                       c.vit_hidden))

  def forward(self, x):
    p = self.patch_embedding(x).flatten(2).transpose(1, 2)
    cls = self.class_embedding.expand(x.shape[0], 1, -1)
    return torch.cat([cls, p], 1) + self.position_embedding


class VisionAttention(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.heads = c.vit_heads
    self.qkv = nn.Linear(c.vit_hidden, 3 * c.vit_hidden)
    self.proj = nn.Linear(c.vit_hidden, c.vit_hidden)

  def forward(self, x):
    N, L, C = x.shape
    q, k, v = self.qkv(x).view(N, L, 3, self.heads, C // self.heads) \
        .permute(2, 0, 3, 1, 4).unbind(0)
    o = F.scaled_dot_product_attention(q, k, v)
    return self.proj(o.transpose(1, 2).reshape(N, L, C))


class VisionMLP(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.fc1 = nn.Linear(c.vit_hidden, c.vit_mlp)
    self.fc2 = nn.Linear(c.vit_mlp, c.vit_hidden)

  def forward(self, x):
    return self.fc2(F.gelu(self.fc1(x)))


class VisionLayer(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.norm1 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.attn = VisionAttention(c)
    self.ls1 = nn.Parameter(torch.ones(c.vit_hidden))
    self.norm2 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.mlp = VisionMLP(c)
    self.ls2 = nn.Parameter(torch.ones(c.vit_hidden))

  def forward(self, x):
    """x: the float32 residual stream. The norms read it rounded to the
    parameters' dtype; each update joins it in float32, scaled by its
    LayerScale in the same pass (``addcmul``)."""
    dt = self.ls1.dtype
    x = torch.addcmul(x, self.attn(self.norm1(x.to(dt))), self.ls1)
    return torch.addcmul(x, self.mlp(self.norm2(x.to(dt))), self.ls2)


class InternViT(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.embeddings = VisionEmbeddings(c)
    self.layers = nn.ModuleList(VisionLayer(c) for _ in range(c.vit_layers))

  def forward(self, x):
    x = self.embeddings(x)
    dt = x.dtype
    x = x.float()
    for layer in self.layers:
      x = layer(x)
    return x.to(dt)


# --- Qwen2 --------------------------------------------------------------------

class RMSNorm(nn.Module):

  def __init__(self, dim: int, eps: float):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(dim))
    self.eps = eps

  def forward(self, x):
    """x in any dtype (the decoder's float32 stream); the result in the
    weight's dtype."""
    h = x.to(torch.float32)
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
    return self.weight * h.to(self.weight.dtype)


class DecoderAttention(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.heads, self.kv_heads = c.heads, c.kv_heads
    self.head_dim = c.hidden // c.heads
    kv = c.kv_heads * self.head_dim
    self.q_proj = nn.Linear(c.hidden, c.hidden)
    self.k_proj = nn.Linear(c.hidden, kv)
    self.v_proj = nn.Linear(c.hidden, kv)
    self.o_proj = nn.Linear(c.hidden, c.hidden, bias=False)

  def forward(self, x, cos, sin):
    B, L, _ = x.shape
    D = self.head_dim
    q = self.q_proj(x).view(B, L, self.heads, D).transpose(1, 2)
    k = self.k_proj(x).view(B, L, self.kv_heads, D).transpose(1, 2)
    v = self.v_proj(x).view(B, L, self.kv_heads, D).transpose(1, 2)
    o = F.scaled_dot_product_attention(
        apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
        is_causal=True, enable_gqa=True)
    return self.o_proj(o.transpose(1, 2).reshape(B, L, self.heads * D))


class DecoderMLP(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.gate_proj = nn.Linear(c.hidden, c.mlp, bias=False)
    self.up_proj = nn.Linear(c.hidden, c.mlp, bias=False)
    self.down_proj = nn.Linear(c.mlp, c.hidden, bias=False)

  def forward(self, x):
    return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.input_layernorm = RMSNorm(c.hidden, c.rms_eps)
    self.self_attn = DecoderAttention(c)
    self.post_attention_layernorm = RMSNorm(c.hidden, c.rms_eps)
    self.mlp = DecoderMLP(c)

  def forward(self, x, cos, sin):
    """x: the float32 residual stream; the norms hand the sublayers their
    input in the parameters' dtype and each update joins the stream in
    float32."""
    x = x + self.self_attn(self.input_layernorm(x), cos, sin)
    return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2(nn.Module):

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.embed_tokens = nn.Embedding(c.vocab, c.hidden)
    self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c.layers))
    self.norm = RMSNorm(c.hidden, c.rms_eps)


def numeric_mlp(n_in: int, width: int) -> nn.Sequential:
  return nn.Sequential(nn.Linear(n_in, width), nn.GELU(),
                       nn.Linear(width, width))


# --- the driving glue -----------------------------------------------------------

class DrivingGlue(nn.Module):
  """SimLingo's driving inputs and read-outs around a vision-language
  model, shared by every VLA of the port (``SimLingo``, ``kimi_vl.KimiVL``):
  the prompt's template and command ids (``prompt_ids``), the image tokens
  spliced in after ``image_at`` ids, the two target-point tokens and the
  speed token (each a small MLP), the learned queries last, and their
  read-outs. Its parameters and buffers sit on the model itself, under the
  names the checkpoints and the benchmark's layouts give them."""

  def init_glue(self, c, hidden: int):
    """Register the glue's parameters and buffers for config `c` (its
    ``template_len``, ``image_at``, ``template_seed``, ``regular_ids``,
    ``path_points`` and ``speed_points``) at the decoder's width."""
    self.target_point_mlp = numeric_mlp(2, hidden)
    self.speed_mlp = numeric_mlp(1, hidden)
    self.queries = nn.Parameter(torch.zeros(c.path_points + c.speed_points,
                                            hidden))
    self.path_head = nn.Linear(hidden, 2)
    self.wp_head = nn.Linear(hidden, 2)
    self.init_prompt(c)

  def init_prompt(self, c, device=None):
    template, commands = prompt_ids(c)
    self.register_buffer("template_ids", template.to(device),
                         persistent=False)
    self.register_buffer("command_ids", commands.to(device),
                         persistent=False)

  def splice(self, table: nn.Embedding, image, target_points, speed,
             command):
    """The decoder's input sequence [B, seq_len, hidden]: the template
    (its last id the command's) with the image tokens after its first
    ``image_at`` ids, the target points, the speed and the queries."""
    c = self.cfg
    B = image.shape[0]
    tmpl = table(self.template_ids)[None].expand(B, -1, -1)
    # the command's row by a one-hot product: exact, and no host sync
    cmd = (command.to(table.weight.dtype) @ table(self.command_ids))[:, None]
    tmpl = torch.cat([tmpl[:, :-1], cmd], 1)
    numbers = torch.cat([self.target_point_mlp(target_points),
                         self.speed_mlp(speed[:, None, None])], 1)
    queries = self.queries[None].expand(B, -1, -1)
    return torch.cat([tmpl[:, :c.image_at], image, tmpl[:, c.image_at:],
                      numbers, queries], 1)

  def read_out(self, q) -> dict:
    """The queries' final states [B, path_points + speed_points, hidden]
    -> {"pred_path": [B,P,2], "pred_wp": [B,W,2]}."""
    P = self.cfg.path_points
    return {"pred_path": self.path_head(q[:, :P]),
            "pred_wp": self.wp_head(q[:, P:])}


# --- the driving model ----------------------------------------------------------

class SimLingo(DrivingGlue):
  """InternVL2-1B with SimLingo's driving inputs and read-outs (see the
  module's docstring)."""

  def __init__(self, c: SimLingoConfig):
    super().__init__()
    self.cfg = c
    self.vision_model = InternViT(c)
    w4 = 4 * c.vit_hidden
    self.mlp1 = nn.Sequential(nn.LayerNorm(w4, eps=c.proj_eps),
                              nn.Linear(w4, c.hidden), nn.GELU(),
                              nn.Linear(c.hidden, c.hidden))
    self.language_model = Qwen2(c)
    self.init_glue(c, c.hidden)

  def image_tokens(self, tiles):
    """tiles [B,T,3,S,S] -> [B, T * tokens_per_tile, hidden]."""
    B, T = tiles.shape[:2]
    x = self.vision_model(tiles.flatten(0, 1))[:, 1:]
    side = int(x.shape[1] ** 0.5)
    x = pixel_shuffle(x.reshape(B * T, side, side, -1))
    return self.mlp1(x.reshape(B, -1, x.shape[-1]))

  def embed(self, image, target_points, speed, command):
    """The decoder's input sequence (``DrivingGlue.splice``)."""
    return self.splice(self.language_model.embed_tokens, image,
                       target_points, speed, command)

  def forward(self, tiles, target_points, speed, command):
    c = self.cfg
    with span("model.vision", count=tiles.shape[0] * tiles.shape[1]):
      image = self.image_tokens(tiles)
    B = tiles.shape[0]
    with span("model.language", count=B * c.seq_len):
      x = self.embed(image, target_points, speed, command)
      lm = self.language_model
      cos, sin = rope_cos_sin(x.shape[1], c.hidden // c.heads, c.rope_theta,
                              x.device, x.dtype)
      x = x.float()
      for layer in lm.layers:
        x = layer(x, cos, sin)
      return self.read_out(lm.norm(x[:, -(c.path_points + c.speed_points):]))
