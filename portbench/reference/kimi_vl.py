"""The plain reference of Kimi-VL-A3B in SimLingo's driving mode
(configuration ``kimi_vl``) in plain torch, run in float32 with TF32 off,
and its sensor policy over the frozen ``cgt`` pieces. Nothing here
imports the port.

The model is Kimi-VL-A3B-Instruct (arXiv:2504.07491; the released
``config.json`` and modeling code), written from the published
equations:

- MoonViT over the whole 896x448 frame (SigLIP's normalisation, x / 0.5
  - 1): ``Conv2d(3, 1152, 14, stride 14)`` with bias over the patches row
  by row, plus the 64x64x1152 position table resized to the 32x64 patch
  grid by ``F.interpolate(..., mode="bicubic")``; 27 blocks ``x = x +
  wo(Attn(q, k, v))`` with ``q, k, v = wqkv(norm0(x))`` (16 heads of 72,
  biases), q and k turned by the 2D RoPE as the released code does it
  (each head's 72 values as 36 complex numbers times ``polar(1, angle)``,
  number 2i at the column's angle and 2i + 1 at the row's, frequency i
  theta^(-4i / 72), theta 10,000), bidirectional SoftMax(QK^T /
  sqrt(72)) V by matmul, then ``x = x + fc1(gelu_tanh(fc0(norm1(x))))``
  (4,304 wide); a final LayerNorm (eps 1e-5 throughout);
- the projector: 2x2 blocks of patches merged (``patch_merger``: the
  four patches of a block, row by row, side by side), ``pre_norm``
  (LayerNorm(1152)) on each patch, ``linear_1`` (4,608 -> 4,608), exact
  GELU, ``linear_2`` (4,608 -> 2,048);
- the decoder (DeepSeek-V3's equations): 27 layers ``h = x +
  o(MLA(n1 x))``, ``x' = h + MLP(n2 h)`` with RMSNorm (eps 1e-5) in
  float32. MLA without a query LoRA: ``q = q_proj(y)`` [16 x (128 +
  64)], ``kv_a_proj_with_mqa(y)`` = [latent 512, k_pe 64], ``kv =
  kv_b_proj(RMSNorm(latent))`` [16 x (128 + 128)] = [k_nope, v]; q_pe
  and the shared k_pe (each taken as interleaved pairs, ``view(d/2,
  2).transpose``) rotated in the rotate-half layout with theta 800,000;
  SoftMax([q_nope, q_pe] [k_nope, k_pe]^T / sqrt(192) + causal mask) V.
  Layer 0's MLP is a SwiGLU of 11,264; layers 1-26 a mixture of experts:
  float32 logits ``y W_gate^T``, sigmoid scores s, the top 6 of s +
  ``e_score_correction_bias``, weights s of those 6 over their sum, times
  2.446; each of the 64 routed SwiGLU experts (1,408) computes the
  tokens routed to it by plain matmuls (a loop over the experts with
  index lists) and the weighted outputs are added to each token's; the 2
  shared experts are one SwiGLU of 2,816 on every token; a final RMSNorm.

The driving glue is SimLingo's (``reference/simlingo.py``; the
configuration's ``assumed``): the template ids with the command's id
last, the image tokens after ``image_at`` ids (embedded ids with the
image's rows scattered in where the image-context id stands), two
target-point tokens and a speed token (2 -> 2048 -> 2048 and 1 -> 2048
-> 2048, exact GELU), and 20 path and 8 speed-waypoint queries last, read
out by ``Linear(2048, 2)`` each.

Departures from the published model, each shared with the program:

- no language-model head (163,840 x 2,048): driving reads the queries;
- the tokenized chat prompt is a template of ids drawn once from the
  configuration's ``template_seed`` among the tokenizer's regular ids,
  the command its last id;
- SimLingo's text digits for the target points and the speed are the two
  MLPs above;
- the weights are random from the seed, each tensor drawn from its own
  seed (``configs/kimi_vl.py``), so that the routed experts' float32
  weights (14.4B parameters, 58 GB) need not be held: where an expert's
  weights are left empty (``ExpertSlot``), they are drawn when its layer
  runs and dropped after it, so the check fits one card with the control;
- where the program's choice of experts at the same tick is given
  (``make_policy``'s ``routes``, as the check gives it), a token's 6 are
  the program's where they are a top 6 of this model's own biased
  scores to within the configuration's ``routes`` ``tie`` (``near_tie``:
  the best score left out exceeds the worst taken by no more), and this
  model's own top 6 everywhere else; the scores, weights and every
  expert's output are this model's own. In bf16 the program's choice
  differs from this model's own in about a tenth of token-layers, all of
  them near-ties, and with its own choice throughout the reference's
  outputs drift nearly as far as the fp8 control's (the configuration's
  ``assumed`` ``routes``). A program that picks other experts (without
  the bias, by another score, under other ids) misses by more than the
  tie and gets this model's choice.

The forward runs the whole batch layer by layer (attention a sample at a
time, so that the float32 scores fit), with TF32 off
(``lowp.exact_float32``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import sys

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.lowp import exact_float32
from portbench.reference.simlingo import (PATH_AIM, attention,
                                          img_context_id, rms_norm,
                                          template_and_commands)

SIGLIP_MEAN = SIGLIP_STD = 0.5


@dataclasses.dataclass(frozen=True)
class KimiConfig:
  camera_width: int = 896
  camera_height: int = 448
  camera_fov: float = 110.0
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
  regular_ids: int = 163584
  template_len: int = 40
  image_at: int = 8
  template_seed: int = 0
  path_points: int = 20
  speed_points: int = 8


def image_tokens(c: KimiConfig) -> int:
  return (c.camera_height // c.patch // c.merge) * \
      (c.camera_width // c.patch // c.merge)


def seq_len(c: KimiConfig) -> int:
  return c.template_len + image_tokens(c) + 3 + c.path_points + \
      c.speed_points


# --- the equations --------------------------------------------------------------

def rope2d_freqs(rows: int, cols: int, head_dim: int, theta: float,
                 device):
  """MoonViT's ``Rope2DPosEmb``: complex [rows * cols, head_dim / 2]."""
  flat = torch.arange(rows * cols, dtype=torch.float32, device=device)
  x_pos, y_pos = flat % cols, flat // cols
  dim_range = torch.arange(0, head_dim, 4, device=device)[:head_dim // 4] \
      .float()
  freqs = 1.0 / (theta ** (dim_range / head_dim))
  x_cis = torch.polar(torch.ones(rows * cols, head_dim // 4, device=device),
                      torch.outer(x_pos, freqs))
  y_cis = torch.polar(torch.ones(rows * cols, head_dim // 4, device=device),
                      torch.outer(y_pos, freqs))
  return torch.cat([x_cis[..., None], y_cis[..., None]], -1) \
      .reshape(rows * cols, -1)


def apply_rope2d(x, freqs_cis):
  """MoonViT's ``apply_rope`` on x [..., N, d]."""
  x_ = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
  return torch.view_as_real(x_ * freqs_cis).flatten(-2).type_as(x)


def rope_deepseek(x, theta: float):
  """DeepSeek-V3's ``apply_rotary_pos_emb`` of x [heads, L, d] at
  positions 0..L-1: the interleaved pairs de-interleaved, then
  rotate-half."""
  h, L, d = x.shape
  inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                      device=x.device) / d))
  freqs = torch.outer(torch.arange(L, dtype=torch.float32, device=x.device),
                      inv)
  emb = torch.cat([freqs, freqs], -1)
  cos, sin = emb.cos().to(x.dtype), emb.sin().to(x.dtype)
  x = x.view(h, L, d // 2, 2).transpose(3, 2).reshape(h, L, d)
  rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
  return x * cos + rot * sin


def causal_attention(q, k, v, scale: float):
  """SoftMax(QK^T * scale + causal mask) V by matmul; [heads, L, d]."""
  s = q @ k.transpose(-1, -2) * scale
  L = s.shape[-1]
  mask = torch.ones(L, L, dtype=torch.bool, device=s.device).triu(1)
  return torch.softmax(s.masked_fill(mask, float("-inf")), -1) @ v


# --- the modules (the published names) ---------------------------------------

@dataclasses.dataclass
class ProgramRoutes:
  """The program's chosen experts for one forward, offered to
  ``KimiVLReference.forward``: ids [MoE layers, B * L, top_k] and the
  tie ``near_tie`` allows; ``log`` gets, layer by layer, (the share of
  tokens whose choice differs from this model's own, the share refused,
  the margins of those that differ)."""
  ids: torch.Tensor
  tie: float
  log: list = dataclasses.field(default_factory=list)


def near_tie(choice, own, prog, tie: float):
  """choice [N, E] (the scores plus the bias), own [N, k] its top k,
  prog [N, k] another choice -> (ids [N, k]: a token's prog where it is a
  top k of choice to within `tie`, else its own; margin [N]: the best
  score prog leaves out less the worst it takes, at most 0 where prog is
  a top k of choice, inf where prog is not k distinct experts)."""
  E, k = choice.shape[1], prog.shape[1]
  inside = (prog >= 0) & (prog < E)
  picked = torch.zeros_like(choice, dtype=torch.bool).scatter_(
      1, prog.clamp(0, E - 1), True)
  sound = inside.all(-1) & (picked.sum(-1) == k)
  worst_in = choice.masked_fill(~picked, math.inf).amin(-1)
  best_out = choice.masked_fill(picked, -math.inf).amax(-1)
  margin = torch.where(sound, best_out - worst_in, math.inf)
  return torch.where((margin <= tie)[:, None], prog, own), margin


class _Named(nn.Module):
  """A module with one parameter of its own named ``weight``."""

  def __init__(self, *shape):
    super().__init__()
    self.weight = nn.Parameter(torch.zeros(*shape))


class _PatchEmbed(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.proj = nn.Conv2d(3, c.vit_hidden, c.patch, c.patch)
    self.pos_emb = _Named(c.pos_emb_height, c.pos_emb_width, c.vit_hidden)


class _Fc(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.fc0 = nn.Linear(c.vit_hidden, c.vit_mlp)
    self.fc1 = nn.Linear(c.vit_mlp, c.vit_hidden)


class _Block(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.norm0 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.wqkv = nn.Linear(c.vit_hidden, 3 * c.vit_hidden)
    self.wo = nn.Linear(c.vit_hidden, c.vit_hidden)
    self.norm1 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.mlp = _Fc(c)


class _Encoder(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.blocks = nn.ModuleList(_Block(c) for _ in range(c.vit_layers))
    self.final_layernorm = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)


class _MoonViT(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.patch_embed = _PatchEmbed(c)
    self.encoder = _Encoder(c)


class _Projector(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    w = c.vit_hidden * c.merge ** 2
    self.pre_norm = nn.LayerNorm(c.vit_hidden, eps=c.proj_eps)
    self.linear_1 = nn.Linear(w, w)
    self.linear_2 = nn.Linear(w, c.hidden_size)


class _MLA(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    h, n = c.hidden_size, c.num_attention_heads
    self.q_proj = nn.Linear(h, n * (c.qk_nope_head_dim + c.qk_rope_head_dim),
                            bias=False)
    self.kv_a_proj_with_mqa = nn.Linear(
        h, c.kv_lora_rank + c.qk_rope_head_dim, bias=False)
    self.kv_a_layernorm = _Named(c.kv_lora_rank)
    self.kv_b_proj = nn.Linear(c.kv_lora_rank,
                               n * (c.qk_nope_head_dim + c.v_head_dim),
                               bias=False)
    self.o_proj = nn.Linear(n * c.v_head_dim, h, bias=False)


class _SwiGLU(nn.Module):

  def __init__(self, hidden: int, width: int):
    super().__init__()
    self.gate_proj = nn.Linear(hidden, width, bias=False)
    self.up_proj = nn.Linear(hidden, width, bias=False)
    self.down_proj = nn.Linear(width, hidden, bias=False)

  def forward(self, x):
    return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class ExpertSlot(_SwiGLU):
  """A routed expert. Its weights may be left empty (numel 0) when the
  model is built, with ``name`` its published prefix: ``weights()`` then
  draws them from the model's ``draw`` for the length of a block."""

  name = ""

  def _params(self):
    """(published name, the Parameter that holds the raw weight) of its
    three linears, parametrized (the control's fp8) or not."""
    for key in ("gate_proj", "up_proj", "down_proj"):
      lin = getattr(self, key)
      p = lin.parametrizations.weight.original if \
          hasattr(lin, "parametrizations") else lin.weight
      yield f"{self.name}.{key}.weight", p

  @contextlib.contextmanager
  def weights(self, draw):
    drawn = []
    for name, p in self._params():
      if p.numel() == 0:
        p.data = draw(name).to(p.dtype)
        drawn.append(p)
    try:
      yield self
    finally:
      for p in drawn:
        p.data = p.data.new_empty(0)


class _Gate(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.weight = nn.Parameter(torch.zeros(c.n_routed_experts,
                                           c.hidden_size))
    self.e_score_correction_bias = nn.Parameter(
        torch.zeros(c.n_routed_experts))


class _MoE(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.gate = _Gate(c)
    self.experts = nn.ModuleList(
        ExpertSlot(c.hidden_size, c.moe_intermediate_size)
        for _ in range(c.n_routed_experts))
    self.shared_experts = _SwiGLU(c.hidden_size,
                                  c.moe_intermediate_size *
                                  c.n_shared_experts)


class _Layer(nn.Module):

  def __init__(self, c: KimiConfig, i: int):
    super().__init__()
    self.input_layernorm = _Named(c.hidden_size)
    self.self_attn = _MLA(c)
    self.post_attention_layernorm = _Named(c.hidden_size)
    self.mlp = _MoE(c) if i >= c.first_k_dense_replace else \
        _SwiGLU(c.hidden_size, c.intermediate_size)


class _Decoder(nn.Module):

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
    self.layers = nn.ModuleList(_Layer(c, i)
                                for i in range(c.num_hidden_layers))
    self.norm = _Named(c.hidden_size)


def _numeric(n_in: int, width: int) -> nn.Sequential:
  return nn.Sequential(nn.Linear(n_in, width), nn.GELU(),
                       nn.Linear(width, width))


class KimiVLReference(nn.Module):
  """forward(frames [B,3,H,W], target_points [B,2,2], speed [B], command
  [B,6] one-hot, routes=None) -> {"pred_path": [B,P,2], "pred_wp":
  [B,W,2]}; routes: the program's choice of experts (``ProgramRoutes``).

  ``draw``: None, or a function of a routed expert's weight's published
  name that returns it (float32), for the experts built empty."""

  def __init__(self, c: KimiConfig):
    super().__init__()
    self.cfg = c
    self.vision_tower = _MoonViT(c)
    self.multi_modal_projector = _Projector(c)
    self.language_model = _Decoder(c)
    self.target_point_mlp = _numeric(2, c.hidden_size)
    self.speed_mlp = _numeric(1, c.hidden_size)
    self.queries = nn.Parameter(torch.zeros(c.path_points + c.speed_points,
                                            c.hidden_size))
    self.path_head = nn.Linear(c.hidden_size, 2)
    self.wp_head = nn.Linear(c.hidden_size, 2)
    template, commands = template_and_commands(c)
    self.register_buffer("template_ids", template, persistent=False)
    self.register_buffer("command_ids", commands, persistent=False)
    for name, m in self.named_modules():
      if isinstance(m, ExpertSlot):
        m.name = name
    self.draw = None

  # --- MoonViT and the projector -----------------------------------------------

  def vit(self, frames):
    """[B,3,H,W] -> the final norm's states [B, rows * cols, C]."""
    c, m = self.cfg, self.vision_tower
    pe = m.patch_embed
    x = pe.proj(frames)
    rows, cols = x.shape[-2:]
    x = x.flatten(2).transpose(1, 2)
    w = pe.pos_emb.weight
    if tuple(w.shape[:2]) != (rows, cols):
      w = F.interpolate(w.permute(2, 0, 1)[None], size=(rows, cols),
                        mode="bicubic")[0].permute(1, 2, 0)
    x = x + w.flatten(0, 1)
    B, N, C = x.shape
    n = c.vit_heads
    d = C // n
    freqs = rope2d_freqs(rows, cols, d, c.vit_rope_theta, x.device)
    for blk in m.encoder.blocks:
      qkv = blk.wqkv(blk.norm0(x)).reshape(B, N, 3, n, d)
      q, k, v = qkv.unbind(2)
      q, k = apply_rope2d(q, freqs[:, None]), apply_rope2d(k, freqs[:, None])
      a = torch.stack([attention(q[b].transpose(0, 1), k[b].transpose(0, 1),
                                 v[b].transpose(0, 1), causal=False)
                       for b in range(B)])
      x = x + blk.wo(a.transpose(1, 2).reshape(B, N, C))
      x = x + blk.mlp.fc1(F.gelu(blk.mlp.fc0(blk.norm1(x)),
                                 approximate="tanh"))
    return m.encoder.final_layernorm(x), rows, cols

  def image_embeds(self, frames):
    """MoonViT, ``patch_merger`` and the projector: [B, T, hidden]."""
    c, p = self.cfg, self.multi_modal_projector
    x, rows, cols = self.vit(frames)
    B, _, C = x.shape
    k = c.merge
    x = x.view(B, rows // k, k, cols // k, k, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, -1, k * k, C)
    x = p.pre_norm(x).reshape(B, -1, k * k * C)
    return p.linear_2(F.gelu(p.linear_1(x)))

  # --- the decoder --------------------------------------------------------------

  def sequence(self, image, target_points, speed, command):
    """The decoder's inputs [L, hidden] of one sample."""
    c = self.cfg
    lm = self.language_model
    cmd = self.command_ids.index_select(0, torch.argmax(command)[None])
    ids = torch.cat([self.template_ids[:-1], cmd])
    ctx = torch.full((image.shape[0],), img_context_id(c),
                     dtype=ids.dtype, device=ids.device)
    ids = torch.cat([ids[:c.image_at], ctx, ids[c.image_at:]])
    embeds = lm.embed_tokens(ids)
    selected = (ids == img_context_id(c))[:, None]
    embeds = embeds.masked_scatter(selected, image.to(embeds.dtype))
    return torch.cat([embeds, self.target_point_mlp(target_points),
                      self.speed_mlp(speed.reshape(1, 1)), self.queries])

  def mla(self, sa, y):
    """Latent attention of y [B, L, H], a sample at a time."""
    c = self.cfg
    B, L, _ = y.shape
    n, dn, dr, dv = (c.num_attention_heads, c.qk_nope_head_dim,
                     c.qk_rope_head_dim, c.v_head_dim)
    out = []
    for b in range(B):
      q = sa.q_proj(y[b]).view(L, n, dn + dr).transpose(0, 1)
      q_nope, q_pe = q.split([dn, dr], -1)
      latent, k_pe = sa.kv_a_proj_with_mqa(y[b]).split([c.kv_lora_rank, dr],
                                                       -1)
      kv = sa.kv_b_proj(rms_norm(latent, sa.kv_a_layernorm.weight,
                                 c.rms_norm_eps)) \
          .view(L, n, dn + dv).transpose(0, 1)
      k_nope, v = kv.split([dn, dv], -1)
      q_pe = rope_deepseek(q_pe, c.rope_theta)
      k_pe = rope_deepseek(k_pe.view(1, L, dr), c.rope_theta)
      q = torch.cat([q_nope, q_pe], -1)
      k = torch.cat([k_nope, k_pe.expand(n, L, dr)], -1)
      a = causal_attention(q, k, v, (dn + dr) ** -0.5)
      out.append(a.transpose(0, 1).reshape(L, n * dv))
    return sa.o_proj(torch.stack(out))

  def moe(self, mlp, y, j: int, routes: ProgramRoutes | None = None):
    """The mixture of experts of layer j (counted among the MoE layers) on
    y [N, H], with the program's choice of experts where ``near_tie``
    takes it."""
    c = self.cfg
    g = mlp.gate
    scores = F.linear(y.float(), g.weight.float()).sigmoid()
    choice = scores + g.e_score_correction_bias
    ids = torch.topk(choice, c.num_experts_per_tok, dim=-1).indices
    if routes is not None:
      prog = routes.ids[j].to(ids.device, torch.int64)
      differs = (ids.sort(-1).values != prog.sort(-1).values).any(-1)
      ids, margin = near_tie(choice, ids, prog, routes.tie)
      routes.log.append((differs.float().mean().item(),
                         (margin > routes.tie).float().mean().item(),
                         margin[differs].cpu()))
    w = scores.gather(1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * c.routed_scaling_factor
    out = torch.zeros_like(y)
    for e, ex in enumerate(mlp.experts):
      if y.is_meta:
        # on the meta device (the FLOP count) the choice is unknown: every
        # token takes experts 0..top_k-1, as many pairs as any choice
        if e >= c.num_experts_per_tok:
          break
        rows = torch.arange(y.shape[0], device=y.device)
        slots = torch.full_like(rows, e)
      else:
        rows, slots = torch.nonzero(ids == e, as_tuple=True)
      if rows.numel() == 0:
        continue
      with ex.weights(self.draw):
        h = ex(y[rows])
      out.index_add_(0, rows, (h * w[rows, slots, None]).to(out.dtype))
    return out + mlp.shared_experts(y)

  def decoder(self, x, routes: ProgramRoutes | None = None):
    """x [B, L, H] -> the queries' final states [B, P + W, H]."""
    c = self.cfg
    lm = self.language_model
    B, L, H = x.shape
    for i, layer in enumerate(lm.layers):
      y = rms_norm(x, layer.input_layernorm.weight, c.rms_norm_eps)
      h = x + self.mla(layer.self_attn, y)
      y = rms_norm(h, layer.post_attention_layernorm.weight, c.rms_norm_eps)
      if isinstance(layer.mlp, _MoE):
        x = h + self.moe(layer.mlp, y.reshape(B * L, H),
                         i - c.first_k_dense_replace, routes).view(B, L, H)
      else:
        x = h + layer.mlp(y)
    n = c.path_points + c.speed_points
    return rms_norm(x[:, -n:], lm.norm.weight, c.rms_norm_eps)

  def forward(self, frames, target_points, speed, command,
              routes: ProgramRoutes | None = None):
    c = self.cfg
    with exact_float32():
      image = self.image_embeds(frames)
      x = torch.stack([self.sequence(image[b], target_points[b], speed[b],
                                     command[b])
                       for b in range(frames.shape[0])])
      q = self.decoder(x, routes)
      return {"pred_path": self.path_head(q[:, :c.path_points]),
              "pred_wp": self.wp_head(q[:, c.path_points:])}


def model(c: KimiConfig) -> KimiVLReference:
  return KimiVLReference(c)


# --- the sensor policy --------------------------------------------------------------

def frames(rgb):
  """The whole frame [B,H,W,3] (0..1) at native resolution, normalised as
  MoonViT's image processor does: [B,3,H,W]."""
  return (rgb.permute(0, 3, 1, 2) - SIGLIP_MEAN) / SIGLIP_STD


def make_policy(net: nn.Module, c: KimiConfig, camera_grid,
                lidar_grid_front, lidar_grid_rear, bf16: bool = False,
                routes: dict | None = None, tie: float = 0.0):
  """``reference/simlingo.make_policy`` with Kimi-VL's camera input: the
  camera-only sensor policy for the frozen ``cgt.sim.episode.sim_step``:
  localization, the route planners, the whole camera frame through
  ``frames``, the LiDAR half sweep for the creep recovery's safety box
  only, the forward (bf16: weights and inputs in bfloat16, the outputs
  back in float32), and the direct controller at the path point
  ``PATH_AIM`` with the target speed of the speed waypoints
  (``cgt.agents.controllers.control_pid``'s desired speed, 0 where it
  brakes).

  routes: {tick: the program's chosen experts [moe layers, B * L,
  top_k]} at the ticks it kept them, for a ``KimiVLReference`` `net`; at
  those ticks the forward takes them where they are near-ties of its own
  (``near_tie`` within `tie`), and how often they differ, how often they
  are refused and by what margins goes to standard error."""
  from portbench.reference.cgt.agents.controllers import control_pid_direct
  from portbench.reference.cgt.agents.sensor_agent import (
      COMPASS_NOISE, GNSS_NOISE_M, command_onehot)
  from portbench.reference.cgt.sensors.camera import render_camera
  from portbench.reference.cgt.sensors.lidar import render_lidar
  from portbench.reference.cgt.sim import geometry as geo
  from portbench.reference.cgt.sim.expert import (Control,
                                                  _dense_planner_params,
                                                  _sparse_planner_params,
                                                  _sparse_seg_len)
  from portbench.reference.cgt.sim.route_planner import (planner_step,
                                                         route_lookup)
  from portbench.reference.cgt.sim.ukf import ukf_predict, ukf_update

  dev = next(net.parameters()).device
  m = (copy.deepcopy(net).to(torch.bfloat16) if bf16 else net).eval()
  cam_grid = torch.as_tensor(camera_grid, device=dev)
  g_front = torch.as_tensor(lidar_grid_front, device=dev).reshape(-1, 3)
  g_rear = torch.as_tensor(lidar_grid_rear, device=dev).reshape(-1, 3)

  @torch.no_grad()
  def policy(cfg, maps, scene, state, generator=None, draws=None):
    draws = draws or {}
    ag, ego = state.agent, state.ego
    B = ego.yaw.shape[0]

    def draw(key, shape, fn):
      x = draws.get(key)
      return fn(shape, generator=generator, device=dev) if x is None else x

    gps = ego.pos + GNSS_NOISE_M * draw("gps", (B, 2), torch.randn)
    compass = ego.yaw + COMPASS_NOISE * draw("compass", (B,), torch.randn)
    ukf = ukf_predict(ag.ukf, ag.prev_control[:, 0], ag.prev_control[:, 1],
                      ag.prev_control[:, 2], cfg.sim)
    ukf = ukf_update(ukf, torch.stack([gps[:, 0], gps[:, 1], compass,
                                       ego.speed], -1))
    pos_f, yaw_f = ukf.x[:, :2], ukf.x[:, 2]
    route = scene.route
    pl_dense = planner_step(ag.planner_dense, route.points, route.seg_len,
                            route.num_valid, pos_f,
                            _dense_planner_params(cfg))
    pl_sparse = planner_step(
        ag.planner_sparse, route.sparse_points,
        _sparse_seg_len(route.sparse_points, route.sparse_num_valid),
        route.sparse_num_valid, pos_f, _sparse_planner_params(cfg))
    tps, cmd = [], None
    for offset in (1, 2):
      tp_world, cmd_k = route_lookup(route.sparse_points, route.sparse_cmd,
                                     route.sparse_num_valid, pl_sparse.idx,
                                     offset)
      tps.append(geo.world_to_ego(tp_world, pos_f, yaw_f))
      cmd = cmd_k if cmd is None else cmd
    target_points = torch.stack(tps, 1)

    rgb = render_camera(cfg, maps, scene, state, cam_grid)["rgb"]
    even = (state.tick % 2 == 0)[:, None, None]
    grid_sel = torch.where(even, g_front[None], g_rear[None])
    pts_now, val_now = render_lidar(cfg, maps, scene, state, grid_sel,
                                    uniform=draws.get("lidar"),
                                    per_episode=True, generator=generator)
    prev_world = geo.ego_to_world(ag.prev_lidar[:, 0, :, :2],
                                  ag.prev_pose[:, 0, None, :2],
                                  ag.prev_pose[:, 0, 2][:, None])
    prev_pts = torch.cat([geo.world_to_ego(prev_world, pos_f[:, None],
                                           yaw_f[:, None]),
                          ag.prev_lidar[:, 0, :, 2:]], -1)
    merged_pts = torch.cat([pts_now, prev_pts], 1)
    merged_val = torch.cat([val_now, ag.prev_lidar_valid[:, 0]], 1)

    inputs = (frames(rgb), target_points, ego.speed, command_onehot(cmd))
    if bf16:
      inputs = tuple(x.to(torch.bfloat16) for x in inputs)
    tick = int(state.tick.max())
    kw = {}
    if routes is not None:
      if tick in routes:
        kw["routes"] = ProgramRoutes(routes[tick], tie)
      else:
        print(f"kimi_vl routes: tick {tick}, none kept: the reference's "
              f"own choice of experts throughout", file=sys.stderr)
    out = {k: v.to(torch.float32) for k, v in m(*inputs, **kw).items()}
    if kw:
      print_routes(tick, kw["routes"], "bf16" if bf16 else "float32")

    wp = out["pred_wp"]
    desired = torch.linalg.vector_norm(wp[:, 1] - wp[:, 3], dim=-1) * 2.0
    ts = torch.where(desired < 0.4, 0.0, desired)
    aim = out["pred_path"][:, PATH_AIM]
    angle = torch.rad2deg(torch.atan2(aim[:, 1], aim[:, 0])) / 90.0
    steer, throttle, brake, pt2, ps2 = control_pid_direct(
        ag.pid_turn, ag.pid_speed, ts, angle, ego.speed, cfg)

    e, s = cfg.expert, cfg.sim
    stuck = torch.where(ego.speed < 0.1, ag.stuck_count + 1, 0)
    force = torch.where(stuck > e.stuck_threshold, e.creep_duration,
                        torch.clamp(ag.force_move - 1, min=0))
    in_box = (merged_val &
              (merged_pts[..., 0] > s.ego_extent_x) &
              (merged_pts[..., 0] < s.ego_extent_x + 2.5) &
              (torch.abs(merged_pts[..., 1]) < s.ego_extent_y * 0.8) &
              (merged_pts[..., 2] > 0.5) & (merged_pts[..., 2] < 1.5))
    obstructed = torch.any(in_box, -1)
    creeping = (force > 0) & ~obstructed
    force = torch.where((force > 0) & obstructed, e.creep_duration, force)
    throttle = torch.where(creeping, e.creep_throttle, throttle)
    brake = torch.where(creeping, 0.0,
                        torch.where((force > 0) & obstructed, 1.0, brake))
    stuck = torch.where(creeping, 0, stuck)

    control = Control(steer=steer, throttle=throttle, brake=brake)
    pose = torch.stack([pos_f[:, 0], pos_f[:, 1], yaw_f], -1)
    new_ag = ag.replace(
        ukf=ukf, planner_dense=pl_dense, planner_sparse=pl_sparse,
        pid_turn=pt2, pid_speed=ps2,
        prev_control=torch.stack([steer, throttle, brake], -1),
        prev_lidar=pts_now[:, None], prev_lidar_valid=val_now[:, None],
        prev_pose=pose[:, None], stuck_count=stuck.to(torch.int32),
        force_move=force.to(torch.int32))
    return control, {"agent": new_ag}

  policy.draw_specs = (("gps", (2,), "normal"), ("compass", (), "normal"),
                       ("lidar", (g_front.shape[0],), "uniform"))
  return policy



def print_routes(tick: int, routes: ProgramRoutes, cast: str):
  """One line on standard error of how the program's choice of experts
  fared at `tick` in the reference run with `cast`: the share of
  token-layers where it differs from the reference's own, the share
  refused (not a near-tie), and the margins (``near_tie``) of those that
  differ."""
  differs = [d for d, _, _ in routes.log]
  refused = sum(r for _, r, _ in routes.log) / len(routes.log)
  m = torch.cat([x for _, _, x in routes.log]).double()
  qs = ("none differ" if m.numel() == 0 else
        "margins of those that differ: median, 99th, 99.9th percentile, "
        "max " + ", ".join(repr(float(v)) for v in (
            m.quantile(0.5), m.quantile(0.99), m.quantile(0.999), m.max())))
  print(f"kimi_vl routes: tick {tick}, the program's choice of experts "
        f"differs from the {cast} reference's own in "
        f"{100 * sum(differs) / len(differs)!r}% of token-layers (worst "
        f"layer {100 * max(differs)!r}%); refused beyond the tie "
        f"{routes.tie!r} in {100 * refused!r}%; {qs}", file=sys.stderr)


def camera_config(cfg, c: KimiConfig):
  """`cfg` with the model's own camera."""
  return cfg.replace(sensor=dataclasses.replace(
      cfg.sensor, camera_width=c.camera_width,
      camera_height=c.camera_height, camera_fov=c.camera_fov))


# --- the costs the rooflines and the MFU read ----------------------------------

def moe_cost(batch: int, c: KimiConfig = KimiConfig(), nbytes: int = 2
             ) -> tuple:
  """(HBM bytes, operations) of the decoder's mixture-of-experts layers
  (router through combine, the program's span ``model.moe``) over
  `batch` samples of ``seq_len`` tokens. Operations: 2 a multiply-add of
  the router's logits and of exactly ``num_experts_per_tok`` routed and
  the shared experts' SwiGLU (three matmuls each) a token. Bytes: every
  expert's weights read once a layer at `nbytes` a value, the router's in
  float32, each token's input read once at `nbytes` and its float32
  update written once; nothing in between (a fused layer keeps it on
  chip)."""
  tok = batch * seq_len(c)
  h, E, W = c.hidden_size, c.n_routed_experts, c.moe_intermediate_size
  k, S = c.num_experts_per_tok, c.n_shared_experts * W
  flops = 2 * tok * (h * E + k * 3 * h * W + 3 * h * S)
  n_bytes = nbytes * (E * 3 * h * W + 3 * h * S) + 4 * E * h + 4 * E + \
      tok * (nbytes * h + 4 * h)
  n = c.num_hidden_layers - c.first_k_dense_replace
  return n * n_bytes, n * flops


def vlm_cost(batch: int, c: KimiConfig = KimiConfig(), nbytes: int = 2
             ) -> tuple:
  """(HBM bytes, operations) of MoonViT, the projector and the decoder
  over `batch` samples, as the program runs them. Operations: 2 a
  multiply-add of the patch embedding, every linear layer (of the MoE
  layers exactly ``moe_cost``'s: 6 routed and the shared experts a token)
  and the attention's two matmuls over every pair of tokens (the causal
  mask's half included, as ``FlopCounterMode`` counts it for the other
  configurations). Bytes at `nbytes` a value: every parameter read once
  (all 64 experts of each layer; the routers' in float32), the pixels, and
  each linear layer's input and output and attention's q, k, v and output
  once each; ``moe_cost``'s bytes for the MoE layers. The glue's MLPs and
  read-outs, under 0.01% of either, are left out."""
  P, C, M = c.patch, c.vit_hidden, c.vit_mlp
  N = (c.camera_height // P) * (c.camera_width // P)
  T = image_tokens(c)
  pix = batch * 3 * c.camera_height * c.camera_width
  flops = 2 * batch * N * 3 * P * P * C
  w = 3 * P * P * C + C + c.pos_emb_height * c.pos_emb_width * C
  act = pix + batch * N * C
  per_layer_w = 4 * C + 3 * C * C + 3 * C + C * C + C + 2 * C * M + M + C
  per_tok = (C + 3 * C) + 4 * C + (C + C) + (C + M) + (M + C)
  flops += c.vit_layers * batch * (2 * N * (4 * C * C + 2 * C * M)
                                   + 2 * 2 * N * N * C)
  w += c.vit_layers * per_layer_w + 2 * C
  act += c.vit_layers * batch * N * per_tok
  # the projector
  m4 = c.merge ** 2 * C
  h = c.hidden_size
  flops += 2 * batch * T * (m4 * m4 + m4 * h)
  w += 2 * C + m4 * m4 + m4 + m4 * h + h
  act += batch * T * (2 * m4 + m4 + m4 + h)
  # the decoder
  L = seq_len(c)
  tok = batch * L
  n = c.num_attention_heads
  dq = c.qk_nope_head_dim + c.qk_rope_head_dim
  r, dv = c.kv_lora_rank, c.v_head_dim
  mla_w = h * n * dq + h * (r + c.qk_rope_head_dim) + r + \
      r * n * (c.qk_nope_head_dim + dv) + n * dv * h + 2 * h
  mla_tok = (h + n * dq) + (h + r + c.qk_rope_head_dim) + \
      (r + n * (c.qk_nope_head_dim + dv)) + (n * dq + n * dq + n * dv) + \
      (n * dv + h)
  flops += c.num_hidden_layers * (
      2 * tok * (h * n * dq + h * (r + c.qk_rope_head_dim)
                 + r * n * (c.qk_nope_head_dim + dv) + n * dv * h)
      + 2 * batch * L * L * n * (dq + dv))
  w += c.num_hidden_layers * mla_w + c.vocab_size * h + h
  act += c.num_hidden_layers * tok * mla_tok
  D = c.intermediate_size
  dense = c.first_k_dense_replace
  flops += dense * 2 * tok * 3 * h * D
  w += dense * 3 * h * D
  act += dense * tok * (h + 2 * D + D + h)
  moe_bytes, moe_flops = moe_cost(batch, c, nbytes)
  return nbytes * (w + act) + moe_bytes, flops + moe_flops
