"""Kimi-VL-A3B (Kimi Team, "Kimi-VL Technical Report", arXiv:2504.07491;
https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct) in SimLingo's
driving mode: one forward a tick, no decoding, the driving glue of
``vla.DrivingGlue`` around MoonViT and a DeepSeek-V3-style decoder.

- MoonViT at native resolution: the whole camera frame, normalised with
  SigLIP's mean = std = 0.5 (``agents.sensor_agent.camera_native``), cut
  into 14x14 patches row by row (``Conv2d`` with bias); a learned 64x64
  position table, bicubically interpolated to the patch grid, is added.
  Pre-LayerNorm blocks ``x = x + wo(Attn(RoPE2D(wqkv(norm0(x)))))``,
  ``x = x + fc1(gelu_tanh(fc0(norm1(x))))`` with biases, bidirectional
  attention over the frame's patches, then a final LayerNorm. The 2D RoPE
  (theta 10,000) turns each head's 36 interleaved pairs, pair 2i by the
  patch's column times frequency i and pair 2i + 1 by its row, computed in
  float32 as the released code does.
- Projector: each 2x2 block of patches merged into one token (the four
  patches, row by row, side by side), ``LayerNorm(1152)`` on each patch
  first, then ``Linear(4608, 4608)``, exact GELU, ``Linear(4608, 2048)``.
- Decoder: 27 pre-norm layers with RMSNorm (eps 1e-5), latent attention
  (``mla.MLA``: no query LoRA, latent 512, heads of 128 + 64 for q and k
  and 128 for v, RoPE theta 800,000) in each; layer 0 has a dense SwiGLU
  of 11,264, layers 1-26 a mixture of experts (``moe.MoE``: 64 routed
  SwiGLU experts of 1,408, 6 a token, and 2 shared ones as one SwiGLU of
  2,816; sigmoid router with its selection bias, renormalised, times
  2.446); a final RMSNorm. No language-model head: driving reads the
  queries out.

Both towers' residual streams are float32 whatever the parameters' dtype
(as in ``vla.SimLingo``: in bf16 the stream's rounding takes the driving
outputs away from the float32 model's); the norms hand each sublayer its
input in the parameters' dtype and each update joins the stream in
float32. The routers' weights stay float32 (``load_published``).

``forward(frames [B,3,H,W], target_points [B,2,2], speed [B], command
[B,6] one-hot) -> {"pred_path": [B,P,2], "pred_wp": [B,W,2]}``. MoonViT
through the projector runs inside the span ``model.vision`` (counting the
frames), the splice through the read-outs inside ``model.language``
(counting the tokens), with ``model.mla`` and ``model.moe`` inside it. The
buffer ``expert_load`` [26, 64] gains the tokens each expert took, layer
by layer, every forward; ``routes`` holds the last forward's chosen
experts [26, B * L, 6].
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from carla_garage_tpu_torch.models.mla import MLA
from carla_garage_tpu_torch.models.moe import MoE, Experts, Router, SwiGLU
from carla_garage_tpu_torch.models.vla import (DrivingGlue, RMSNorm,
                                               rope_cos_sin)
from carla_garage_tpu_torch.utils.profiling import counter, span


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
  """Kimi-VL-A3B-Instruct's published widths (the decoder's keys as its
  ``config.json`` names them; MoonViT's from its ``vision_config``) and
  the driving glue's sizes."""
  # the camera, whole at native resolution
  camera_width: int = 896
  camera_height: int = 448
  camera_fov: float = 110.0
  # MoonViT
  patch: int = 14
  pos_emb_height: int = 64
  pos_emb_width: int = 64
  vit_hidden: int = 1152
  vit_layers: int = 27
  vit_heads: int = 16
  vit_mlp: int = 4304
  vit_eps: float = 1e-5
  vit_rope_theta: float = 10000.0
  merge: int = 2
  proj_eps: float = 1e-5
  # the DeepSeek-V3-style decoder
  hidden_size: int = 2048
  intermediate_size: int = 11264
  moe_intermediate_size: int = 1408
  num_hidden_layers: int = 27
  num_attention_heads: int = 16
  n_shared_experts: int = 2
  n_routed_experts: int = 64
  num_experts_per_tok: int = 6
  routed_scaling_factor: float = 2.446
  first_k_dense_replace: int = 1
  kv_lora_rank: int = 512
  qk_nope_head_dim: int = 128
  qk_rope_head_dim: int = 64
  v_head_dim: int = 128
  rms_norm_eps: float = 1e-5
  rope_theta: float = 800000.0
  vocab_size: int = 163840
  regular_ids: int = 163584     # the tokenizer's ids below its specials
  # the driving glue
  template_len: int = 40
  image_at: int = 8
  template_seed: int = 0
  path_points: int = 20
  speed_points: int = 8

  @property
  def grid(self) -> tuple:
    """(rows, columns) of patches in a frame."""
    return self.camera_height // self.patch, self.camera_width // self.patch

  @property
  def image_tokens(self) -> int:
    rows, cols = self.grid
    return (rows // self.merge) * (cols // self.merge)

  @property
  def moe_layers(self) -> int:
    return self.num_hidden_layers - self.first_k_dense_replace

  @property
  def seq_len(self) -> int:
    return (self.template_len + self.image_tokens + 3 + self.path_points
            + self.speed_points)


# --- MoonViT -----------------------------------------------------------------

def rope2d_cos_sin(rows: int, cols: int, head_dim: int, theta: float,
                   device):
  """cos and sin [rows * cols, head_dim / 2] (float32) of the patches row
  by row: pair 2i turns by the column times theta^(-4i / head_dim), pair
  2i + 1 by the row times the same."""
  inv = 1.0 / theta ** (torch.arange(0, head_dim, 4, device=device,
                                     dtype=torch.float32)[:head_dim // 4]
                        / head_dim)
  pos = torch.arange(rows * cols, device=device, dtype=torch.float32)
  ang = torch.stack([torch.outer(pos % cols, inv),
                     torch.outer(torch.div(pos, cols, rounding_mode="floor"),
                                 inv)], -1).flatten(1)
  return ang.cos(), ang.sin()


def apply_rope2d(x, cos, sin):
  """x [..., N, d] as d/2 interleaved pairs, each turned by its angle, in
  float32; the result in x's dtype."""
  p = x.float().unflatten(-1, (-1, 2))
  a, b = p[..., 0], p[..., 1]
  return torch.stack([a * cos - b * sin, a * sin + b * cos], -1) \
      .flatten(-2).to(x.dtype)


class PatchEmbed(nn.Module):

  def __init__(self, c: KimiVLConfig):
    super().__init__()
    self.proj = nn.Conv2d(3, c.vit_hidden, c.patch, c.patch)
    self.pos_emb = nn.Module()
    self.pos_emb.weight = nn.Parameter(torch.zeros(
        c.pos_emb_height, c.pos_emb_width, c.vit_hidden))

  def forward(self, frames):
    """frames [B,3,H,W] -> [B, rows * cols, C], patches row by row."""
    x = self.proj(frames)
    rows, cols = x.shape[-2:]
    w = self.pos_emb.weight
    pos = w if tuple(w.shape[:2]) == (rows, cols) else F.interpolate(
        w.float().permute(2, 0, 1)[None], size=(rows, cols),
        mode="bicubic")[0].permute(1, 2, 0)
    return x.flatten(2).transpose(1, 2) + pos.reshape(rows * cols, -1) \
        .to(x.dtype)


def vit_attention(x, wqkv: nn.Linear, wo: nn.Linear, heads: int, cos,
                  sin):
  B, N, C = x.shape
  q, k, v = wqkv(x).view(B, N, 3, heads, C // heads) \
      .permute(2, 0, 3, 1, 4).unbind(0)
  o = F.scaled_dot_product_attention(apply_rope2d(q, cos, sin),
                                     apply_rope2d(k, cos, sin), v)
  return wo(o.transpose(1, 2).reshape(B, N, C))


class VitMLP(nn.Module):

  def __init__(self, c: KimiVLConfig):
    super().__init__()
    self.fc0 = nn.Linear(c.vit_hidden, c.vit_mlp)
    self.fc1 = nn.Linear(c.vit_mlp, c.vit_hidden)

  def forward(self, x):
    return self.fc1(F.gelu(self.fc0(x), approximate="tanh"))


class VitBlock(nn.Module):
  """One MoonViT block, its parameters under the released names."""

  def __init__(self, c: KimiVLConfig):
    super().__init__()
    self.heads = c.vit_heads
    self.norm0 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.wqkv = nn.Linear(c.vit_hidden, 3 * c.vit_hidden)
    self.wo = nn.Linear(c.vit_hidden, c.vit_hidden)
    self.norm1 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.mlp = VitMLP(c)

  def forward(self, x, cos, sin):
    """x: the float32 residual stream."""
    dt = self.norm0.weight.dtype
    x = x + vit_attention(self.norm0(x.to(dt)), self.wqkv, self.wo,
                          self.heads, cos, sin)
    return x + self.mlp(self.norm1(x.to(dt)))


class MoonViT(nn.Module):

  def __init__(self, c: KimiVLConfig):
    super().__init__()
    self.cfg = c
    self.patch_embed = PatchEmbed(c)
    self.encoder = nn.Module()
    self.encoder.blocks = nn.ModuleList(VitBlock(c)
                                        for _ in range(c.vit_layers))
    self.encoder.final_layernorm = nn.LayerNorm(c.vit_hidden,
                                                eps=c.vit_eps)

  def forward(self, frames):
    """frames [B,3,H,W] -> [B, rows * cols, C] after the final norm."""
    c = self.cfg
    x = self.patch_embed(frames)
    rows, cols = frames.shape[-2] // c.patch, frames.shape[-1] // c.patch
    cos, sin = rope2d_cos_sin(rows, cols, c.vit_hidden // c.vit_heads,
                              c.vit_rope_theta, x.device)
    dt = x.dtype
    x = x.float()
    for blk in self.encoder.blocks:
      x = blk(x, cos, sin)
    return self.encoder.final_layernorm(x.to(dt))


class Projector(nn.Module):

  def __init__(self, c: KimiVLConfig):
    super().__init__()
    w = c.vit_hidden * c.merge ** 2
    self.pre_norm = nn.LayerNorm(c.vit_hidden, eps=c.proj_eps)
    self.linear_1 = nn.Linear(w, w)
    self.linear_2 = nn.Linear(w, c.hidden_size)

  def forward(self, x):
    """x [B, T, merge**2, C], each token's merged patches -> [B, T,
    hidden]."""
    x = self.pre_norm(x).flatten(2)
    return self.linear_2(F.gelu(self.linear_1(x)))


def patch_merge(x, rows: int, cols: int, m: int):
  """[B, rows * cols, C] -> [B, rows/m * cols/m, m*m, C]: each m x m block
  of patches, row by row, as one token's m*m parts."""
  B, _, C = x.shape
  return x.view(B, rows // m, m, cols // m, m, C).permute(0, 1, 3, 2, 4, 5) \
      .reshape(B, (rows // m) * (cols // m), m * m, C)


# --- the decoder ----------------------------------------------------------------

class DecoderLayer(nn.Module):

  def __init__(self, c: KimiVLConfig, layer: int):
    super().__init__()
    h = c.hidden_size
    self.input_layernorm = RMSNorm(h, c.rms_norm_eps)
    self.self_attn = MLA(h, c.num_attention_heads, c.qk_nope_head_dim,
                         c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank,
                         c.rms_norm_eps)
    self.post_attention_layernorm = RMSNorm(h, c.rms_norm_eps)
    self.moe = layer >= c.first_k_dense_replace
    self.mlp = MoE(h, c.n_routed_experts, c.num_experts_per_tok,
                   c.moe_intermediate_size, c.n_shared_experts,
                   c.routed_scaling_factor) if self.moe \
        else SwiGLU(h, c.intermediate_size)

  def forward(self, x, cos, sin, load=None, routes=None):
    """x: the float32 residual stream [B, L, H]."""
    x = x + self.self_attn(self.input_layernorm(x), cos, sin)
    h = self.post_attention_layernorm(x)
    if not self.moe:
      return x + self.mlp(h)
    return x + self.mlp(h.flatten(0, 1), load, routes).view_as(x)


class Decoder(nn.Module):

  def __init__(self, c: KimiVLConfig):
    super().__init__()
    self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
    self.layers = nn.ModuleList(DecoderLayer(c, i)
                                for i in range(c.num_hidden_layers))
    self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)


# --- the driving model ----------------------------------------------------------

class KimiVL(DrivingGlue):
  """Kimi-VL-A3B with SimLingo's driving inputs and read-outs (see the
  module's docstring)."""

  def __init__(self, c: KimiVLConfig):
    super().__init__()
    self.cfg = c
    self.vision_tower = MoonViT(c)
    self.multi_modal_projector = Projector(c)
    self.language_model = Decoder(c)
    self.init_glue(c, c.hidden_size)
    self.register_buffer("expert_load", torch.zeros(
        c.moe_layers, c.n_routed_experts, dtype=torch.int64),
        persistent=False)
    self.routes = None
    self.bf16_placed = False

  def image_tokens(self, frames):
    """frames [B,3,H,W] -> [B, image_tokens, hidden]."""
    c = self.cfg
    rows, cols = frames.shape[-2] // c.patch, frames.shape[-1] // c.patch
    return self.multi_modal_projector(
        patch_merge(self.vision_tower(frames), rows, cols, c.merge))

  def forward(self, frames, target_points, speed, command):
    c = self.cfg
    B = frames.shape[0]
    with span("model.vision", count=B):
      image = self.image_tokens(frames)
    with span("model.language", count=B * c.seq_len):
      lm = self.language_model
      x = self.splice(lm.embed_tokens, image, target_points, speed, command)
      N = x.shape[0] * x.shape[1]
      counter("model.moe.expert_load", self.expert_load)
      shape = (c.moe_layers, N, c.num_experts_per_tok)
      if self.routes is None or tuple(self.routes.shape) != shape or \
          self.routes.device != x.device:
        self.routes = torch.zeros(shape, dtype=torch.int64, device=x.device)
      cos, sin = rope_cos_sin(x.shape[1], c.qk_rope_head_dim, c.rope_theta,
                              x.device, x.dtype)
      x = x.float()
      for i, layer in enumerate(lm.layers):
        j = i - c.first_k_dense_replace
        x = layer(x, cos, sin, *((self.expert_load[j], self.routes[j])
                                 if layer.moe else ()))
      return self.read_out(lm.norm(x[:, -(c.path_points + c.speed_points):]))

  def published_spec(self) -> list:
    """[(name, shape)] of the parameters in the published layout: each
    routed expert's gate, up and down projections on their own."""
    out = []
    for name, p in self.named_parameters():
      if not name.endswith(("experts.gate_up", "experts.down")):
        out.append((name, tuple(p.shape)))
        continue
      prefix, kind = name.rsplit(".", 1)
      E, rows, cols = p.shape
      for e in range(E):
        if kind == "gate_up":
          out += [(f"{prefix}.{e}.gate_proj.weight", (rows // 2, cols)),
                  (f"{prefix}.{e}.up_proj.weight", (rows // 2, cols))]
        else:
          out.append((f"{prefix}.{e}.down_proj.weight", (rows, cols)))
    return out

  def load_published(self, fetch, dtype=None):
    """Replace every parameter by the published layout's tensor
    ``fetch(name)`` (each routed expert's ``...mlp.experts.<e>.gate_proj``,
    ``up_proj`` and ``down_proj`` weights stacked into ``Experts``), in
    `dtype` (default: the fetched one), except the routers', which stay
    float32; the buffers are made anew where the tensors live. Works on a
    model built on the meta device: nothing is allocated twice. In bf16
    the model is marked ``bf16_placed``: a bf16 policy runs it as it is."""
    dev = None
    for mname, mod in self.named_modules():
      for pname, _ in list(mod.named_parameters(recurse=False)):
        full = f"{mname}.{pname}" if mname else pname
        if isinstance(mod, Experts):
          t = _stacked(fetch, mname, pname, mod.gate_up.shape[0], dtype)
        else:
          t = fetch(full)
          t = t.to(torch.float32 if isinstance(mod, Router)
                   else (dtype or t.dtype))
        dev = t.device
        setattr(mod, pname, nn.Parameter(t, requires_grad=False))
    self.init_prompt(self.cfg, dev)
    self.expert_load = torch.zeros_like(self.expert_load, device=dev)
    self.routes = None
    self.bf16_placed = dtype == torch.bfloat16
    return self


def _stacked(fetch, prefix: str, pname: str, n: int, dtype):
  """The `n` routed experts' weights of ``<prefix>`` ("...mlp.experts")
  from the published layout, stacked: gate_up [E, 2W, H] (gate rows, then
  up rows) or down [E, H, W]."""
  names = (("gate_proj", "up_proj") if pname == "gate_up"
           else ("down_proj",))
  out = None
  for e in range(n):
    w = torch.cat([fetch(f"{prefix}.{e}.{m}.weight") for m in names], 0)
    if out is None:
      out = torch.empty((n,) + tuple(w.shape), dtype=dtype or w.dtype,
                        device=w.device)
    out[e] = w
  return out
