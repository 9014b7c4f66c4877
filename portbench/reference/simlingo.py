"""The plain reference of SimLingo (configuration ``simlingo``) in plain
torch, run in float32 with TF32 off, and its sensor policy over the
frozen ``cgt`` pieces. Nothing here imports the port.

The model is InternVL2-1B in SimLingo's driving mode (Renz et al.,
CVPR 2025, arXiv:2503.09594), written from the published equations:

- InternViT-300M-448px: ``Conv2d(3, 1024, 14, stride 14)`` with bias, a
  class token and a learned position embedding of 1,025 x 1,024, then 24
  pre-norm blocks ``x = x + ls1 * Attn(LN1(x))``, ``x = x + ls2 *
  MLP(LN2(x))`` (LayerNorm eps 1e-6, 16 heads of 64, ``qkv`` and
  ``proj`` with biases, bidirectional SoftMax(QK^T / 8) V by matmul; MLP
  ``fc1``, exact GELU, ``fc2``), the last block's states without a final
  norm;
- the projector: the class token dropped, the [32, 32, 1024] grid through
  InternVL's ``pixel_shuffle(0.5)``, ``ps_version`` v2, then
  ``LayerNorm(4096)`` (eps 1e-5), ``Linear(4096, 896)``, exact GELU,
  ``Linear(896, 896)``;
- Qwen2-0.5B: 24 layers ``h = x + o(Attn(RoPE(q(n1 x)), RoPE(k(n1 x)),
  v(n1 x)))``, ``x' = h + down(silu(gate(n2 h)) * up(n2 h))``, RMSNorm
  (eps 1e-6) in float32, 14 query heads and 2 key-value heads of 64 (each
  key-value head repeated for 7 query heads), biases on q, k and v only,
  rotate-half RoPE with theta 1e6 over positions 0..L-1, a causal mask
  over the whole sequence, and a final RMSNorm.

The driving glue (the configuration's ``assumed``): the prompt's token ids
(InternVL's way: the template with the image-context id at each image
token's place, embedded, and ``embeds[ids == IMG_CONTEXT] = vit_embeds``),
the command's id last in the template, the two target points through one
MLP (2 -> 896 -> 896, exact GELU), the speed through another (1 -> 896
-> 896), and 20 path and 8 speed-waypoint queries last, each read out by
its own ``Linear(896, 2)``.

Departures from the published model, each shared with the program:

- the tokenized chat prompt is a template of ids drawn once from the
  configuration's ``template_seed`` (its text and the tokenizer are not in
  the repository); the command is its last id, one of six drawn with it;
- SimLingo's text digits for the target points and the speed are tokens
  of the two MLPs above;
- the thumbnail is resized by antialiased bicubic interpolation of the
  float image, where InternVL2 resizes the 8-bit image with PIL's bicubic;
- the weights are random from the seed (``portbench/weights.py``).

The forward runs one sample at a time (its three tiles together), so that
the float32 attention fits, with TF32 off (``lowp.exact_float32``).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.lowp import exact_float32

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PATH_AIM = 2                 # the path point the controller steers at


@dataclasses.dataclass(frozen=True)
class VLAConfig:
  camera_width: int = 896
  camera_height: int = 448
  camera_fov: float = 110.0
  tile: int = 448
  patch: int = 14
  vit_hidden: int = 1024
  vit_layers: int = 24
  vit_heads: int = 16
  vit_mlp: int = 4096
  vit_eps: float = 1e-6
  proj_eps: float = 1e-5
  hidden: int = 896
  layers: int = 24
  heads: int = 14
  kv_heads: int = 2
  mlp: int = 4864
  vocab: int = 151936
  regular_ids: int = 151643
  rms_eps: float = 1e-6
  rope_theta: float = 1e6
  template_len: int = 40
  image_at: int = 8
  template_seed: int = 0
  path_points: int = 20
  speed_points: int = 8


def tiles_of(c: VLAConfig) -> int:
  n = (c.camera_width // c.tile) * (c.camera_height // c.tile)
  return n + 1 if n > 1 else n


def img_context_id(c: VLAConfig) -> int:
  """The image-context token's id: one above the regular ids, never in
  the template."""
  return c.regular_ids + 5


def template_and_commands(c: VLAConfig):
  ids = np.random.default_rng(c.template_seed).integers(
      0, c.regular_ids, c.template_len + 6)
  return (torch.as_tensor(ids[:c.template_len]),
          torch.as_tensor(ids[c.template_len:]))


# --- the equations --------------------------------------------------------------

def attention(q, k, v, causal: bool):
  """SoftMax(QK^T / sqrt(d) [+ causal mask]) V by matmul; [heads, L, d]."""
  s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
  if causal:
    L = s.shape[-1]
    mask = torch.ones(L, L, dtype=torch.bool, device=s.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
  return torch.softmax(s, -1) @ v


def pixel_shuffle_v2(x, scale: float = 0.5):
  """InternVL's pixel_shuffle with ps_version v2, as written there."""
  n, w, h, c = x.size()
  x = x.view(n, w, int(h * scale), int(c / scale))
  x = x.permute(0, 2, 1, 3).contiguous()
  x = x.view(n, int(h * scale), int(w * scale), int(c / (scale * scale)))
  return x.permute(0, 2, 1, 3).contiguous()


def rms_norm(x, weight, eps):
  h = x.to(torch.float32)
  h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
  return weight * h.to(x.dtype)


def rope(x, theta: float):
  """Rotate-half RoPE of x [heads, L, d] at positions 0..L-1, the angles
  in float32."""
  L, d = x.shape[-2:]
  inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                     device=x.device) / d)
  ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * \
      inv[None]
  ang = torch.cat([ang, ang], -1)
  cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
  rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
  return x * cos + rot * sin


# --- the modules (the parameters' names are the program's) ---------------------

class _Embeddings(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    n = (c.tile // c.patch) ** 2
    self.class_embedding = nn.Parameter(torch.zeros(1, 1, c.vit_hidden))
    self.patch_embedding = nn.Conv2d(3, c.vit_hidden, c.patch, c.patch)
    self.position_embedding = nn.Parameter(torch.zeros(1, n + 1,
                                                       c.vit_hidden))


class _Attn(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.qkv = nn.Linear(c.vit_hidden, 3 * c.vit_hidden)
    self.proj = nn.Linear(c.vit_hidden, c.vit_hidden)


class _Mlp(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.fc1 = nn.Linear(c.vit_hidden, c.vit_mlp)
    self.fc2 = nn.Linear(c.vit_mlp, c.vit_hidden)


class _VitLayer(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.norm1 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.attn = _Attn(c)
    self.ls1 = nn.Parameter(torch.ones(c.vit_hidden))
    self.norm2 = nn.LayerNorm(c.vit_hidden, eps=c.vit_eps)
    self.mlp = _Mlp(c)
    self.ls2 = nn.Parameter(torch.ones(c.vit_hidden))


class _Vit(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.embeddings = _Embeddings(c)
    self.layers = nn.ModuleList(_VitLayer(c) for _ in range(c.vit_layers))


class _Norm(nn.Module):

  def __init__(self, dim: int):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(dim))


class _SelfAttn(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    kv = c.kv_heads * (c.hidden // c.heads)
    self.q_proj = nn.Linear(c.hidden, c.hidden)
    self.k_proj = nn.Linear(c.hidden, kv)
    self.v_proj = nn.Linear(c.hidden, kv)
    self.o_proj = nn.Linear(c.hidden, c.hidden, bias=False)


class _SwiGLU(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.gate_proj = nn.Linear(c.hidden, c.mlp, bias=False)
    self.up_proj = nn.Linear(c.hidden, c.mlp, bias=False)
    self.down_proj = nn.Linear(c.mlp, c.hidden, bias=False)


class _DecLayer(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.input_layernorm = _Norm(c.hidden)
    self.self_attn = _SelfAttn(c)
    self.post_attention_layernorm = _Norm(c.hidden)
    self.mlp = _SwiGLU(c)


class _Qwen2(nn.Module):

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.embed_tokens = nn.Embedding(c.vocab, c.hidden)
    self.layers = nn.ModuleList(_DecLayer(c) for _ in range(c.layers))
    self.norm = _Norm(c.hidden)


def _numeric(n_in: int, width: int) -> nn.Sequential:
  return nn.Sequential(nn.Linear(n_in, width), nn.GELU(),
                       nn.Linear(width, width))


class SimLingoReference(nn.Module):
  """forward(tiles [B,T,3,S,S], target_points [B,2,2], speed [B], command
  [B,6] one-hot) -> {"pred_path": [B,P,2], "pred_wp": [B,W,2]}, a sample
  at a time."""

  def __init__(self, c: VLAConfig):
    super().__init__()
    self.cfg = c
    self.vision_model = _Vit(c)
    w4 = 4 * c.vit_hidden
    self.mlp1 = nn.Sequential(nn.LayerNorm(w4, eps=c.proj_eps),
                              nn.Linear(w4, c.hidden), nn.GELU(),
                              nn.Linear(c.hidden, c.hidden))
    self.language_model = _Qwen2(c)
    self.target_point_mlp = _numeric(2, c.hidden)
    self.speed_mlp = _numeric(1, c.hidden)
    self.queries = nn.Parameter(torch.zeros(c.path_points + c.speed_points,
                                            c.hidden))
    self.path_head = nn.Linear(c.hidden, 2)
    self.wp_head = nn.Linear(c.hidden, 2)
    template, commands = template_and_commands(c)
    self.register_buffer("template_ids", template, persistent=False)
    self.register_buffer("command_ids", commands, persistent=False)

  def vit(self, x):
    """tiles [T,3,S,S] -> the last block's states [T, 1 + n, C]."""
    c, m = self.cfg, self.vision_model
    e = m.embeddings
    p = e.patch_embedding(x).flatten(2).transpose(1, 2)
    x = torch.cat([e.class_embedding.expand(x.shape[0], 1, -1), p], 1) + \
        e.position_embedding
    T, N, C = x.shape
    d = C // c.vit_heads
    for blk in m.layers:
      y = blk.norm1(x)
      q, k, v = blk.attn.qkv(y).reshape(T, N, 3, c.vit_heads, d) \
          .permute(2, 0, 3, 1, 4)
      a = attention(q, k, v, causal=False).transpose(1, 2).reshape(T, N, C)
      x = x + blk.attn.proj(a) * blk.ls1
      y = blk.norm2(x)
      x = x + blk.mlp.fc2(F.gelu(blk.mlp.fc1(y))) * blk.ls2
    return x

  def image_embeds(self, tiles):
    """InternVL's extract_feature: [T,3,S,S] -> [T * n/4, hidden]."""
    v = self.vit(tiles)[:, 1:, :]
    h = w = int(v.shape[1] ** 0.5)
    v = pixel_shuffle_v2(v.reshape(v.shape[0], h, w, -1))
    v = v.reshape(v.shape[0], -1, v.shape[-1])
    return self.mlp1(v).reshape(-1, self.cfg.hidden)

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

  def decoder(self, x):
    c = self.cfg
    lm = self.language_model
    L = x.shape[0]
    d = c.hidden // c.heads
    rep = c.heads // c.kv_heads
    for layer in lm.layers:
      sa = layer.self_attn
      y = rms_norm(x, layer.input_layernorm.weight, c.rms_eps)
      q = sa.q_proj(y).reshape(L, c.heads, d).transpose(0, 1)
      k = sa.k_proj(y).reshape(L, c.kv_heads, d).transpose(0, 1)
      v = sa.v_proj(y).reshape(L, c.kv_heads, d).transpose(0, 1)
      q, k = rope(q, c.rope_theta), rope(k, c.rope_theta)
      k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
      a = attention(q, k, v, causal=True).transpose(0, 1).reshape(L, -1)
      h = x + sa.o_proj(a)
      y = rms_norm(h, layer.post_attention_layernorm.weight, c.rms_eps)
      x = h + layer.mlp.down_proj(F.silu(layer.mlp.gate_proj(y)) *
                                  layer.mlp.up_proj(y))
    n = c.path_points + c.speed_points
    return rms_norm(x[-n:], lm.norm.weight, c.rms_eps)

  def forward(self, tiles, target_points, speed, command):
    c = self.cfg
    path, wp = [], []
    with exact_float32():
      for b in range(tiles.shape[0]):
        x = self.sequence(self.image_embeds(tiles[b]), target_points[b],
                          speed[b], command[b])
        q = self.decoder(x)
        path.append(self.path_head(q[:c.path_points]))
        wp.append(self.wp_head(q[c.path_points:]))
    return {"pred_path": torch.stack(path), "pred_wp": torch.stack(wp)}


def model(c: VLAConfig) -> SimLingoReference:
  return SimLingoReference(c)


# --- the sensor policy --------------------------------------------------------------

def tiles(rgb, tile: int):
  """InternVL2's dynamic_preprocess of a frame [B,H,W,3] (0..1) whose
  closest aspect ratio is its own: blocks cropped box by box, row by row,
  then the thumbnail, each normalized -> [B,T,3,tile,tile]."""
  B, H, W, _ = rgb.shape
  x = rgb.permute(0, 3, 1, 2)
  cols, blocks = W // tile, (W // tile) * (H // tile)
  out = []
  for i in range(blocks):
    c0, r0 = (i % cols) * tile, (i // cols) * tile
    out.append(x[:, :, r0:r0 + tile, c0:c0 + tile])
  if blocks != 1:
    out.append(F.interpolate(x, size=(tile, tile), mode="bicubic",
                             align_corners=False, antialias=True))
  t = torch.stack(out, 1)
  mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)[:, None, None]
  std = torch.tensor(IMAGENET_STD, device=rgb.device)[:, None, None]
  return (t - mean) / std


def camera_config(cfg, c: VLAConfig):
  """`cfg` with the model's own camera."""
  return cfg.replace(sensor=dataclasses.replace(
      cfg.sensor, camera_width=c.camera_width,
      camera_height=c.camera_height, camera_fov=c.camera_fov))


def make_policy(net: nn.Module, c: VLAConfig, camera_grid, lidar_grid_front,
                lidar_grid_rear, bf16: bool = False):
  """The camera-only sensor policy for the frozen ``cgt.sim.episode.
  sim_step``: localization, the route planners, the camera through
  ``tiles``, the LiDAR half sweep for the creep recovery's safety box
  only, the forward (bf16: weights and inputs in bfloat16, the outputs
  back in float32), and the direct controller at the path point
  ``PATH_AIM`` with the target speed of the speed waypoints
  (``cgt.agents.controllers.control_pid``'s desired speed, 0 where it
  brakes)."""
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

    inputs = (tiles(rgb, c.tile), target_points, ego.speed,
              command_onehot(cmd))
    if bf16:
      inputs = tuple(x.to(torch.bfloat16) for x in inputs)
    out = {k: v.to(torch.float32) for k, v in m(*inputs).items()}

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


# --- the cost the roofline reads ------------------------------------------------

def vlm_cost(batch: int, c: VLAConfig = VLAConfig(), nbytes: int = 2
             ) -> tuple:
  """(HBM bytes, operations) of the vision tower, the projector and the
  decoder over `batch` samples, as the program runs them. Operations: 2
  a multiply-add of the patch embedding, every linear layer and the
  attention's two matmuls (each tile's 1 + n tokens attending to all,
  the decoder's L tokens each to itself and those before it). Bytes at
  `nbytes` a value: every tensor between the equations' operations
  written once and read once (the pixels, the embedding with its class
  token and positions, the norms' outputs, q, k and v, rotated q and k,
  the attention's and projections' outputs, the MLPs' hidden states with
  the activation in place, SwiGLU's product, the residual sums, the
  pixel shuffle's copy, the spliced sequence), and each weight and bias
  read once; no N x N matrix (a fused kernel keeps it on chip). The
  glue's MLPs and read-outs, under 0.01% of either, are left out."""
  T = batch * tiles_of(c)
  S, P, C, M = c.tile, c.patch, c.vit_hidden, c.vit_mlp
  n = (S // P) ** 2
  N = n + 1
  w_patch = 3 * P * P * C + C
  n_bytes = T * (3 * S * S + n * C + 3 * N * C) + w_patch + 2 * N * C
  flops = 2 * T * n * 3 * P * P * C
  per_tok = 2 * C + 4 * C + 4 * C + 2 * C + 3 * C + 2 * C + (C + M) + \
      (M + C) + 3 * C
  w_layer = 4 * C + 3 * C * C + 3 * C + C * C + C + 2 * C + 2 * C * M + \
      M + C
  n_bytes += c.vit_layers * (T * N * per_tok + w_layer)
  flops += c.vit_layers * T * (2 * N * (4 * C * C + 2 * C * M)
                               + 2 * 2 * N * N * C)
  # the projector: the shuffle's copy, LayerNorm, two linears
  h = c.hidden
  t = n // 4
  n_bytes += T * (2 * n * C + t * (2 * 4 * C + 4 * C + h + 2 * h))
  n_bytes += 2 * 4 * C + 4 * C * h + h + h * h + h
  flops += 2 * T * t * (4 * C * h + h * h)
  # the decoder over L tokens a sample
  L = c.template_len + tiles_of(c) * t + 3 + c.path_points + \
      c.speed_points
  kv = c.kv_heads * (h // c.heads)
  m = c.mlp
  tok = batch * L
  n_bytes += tok * 2 * h + c.template_len * h
  per_tok = (2 * h + 3 * h + h + 2 * kv + 2 * (h + kv) + (h + 2 * kv + h)
             + 2 * h + 3 * h + 2 * h + 2 * (h + m) + 3 * m + (m + h)
             + 3 * h)
  w_layer = 2 * h + h * h + h + 2 * (h * kv + kv) + h * h + 3 * h * m
  n_bytes += c.layers * (tok * per_tok + w_layer)
  flops += c.layers * (2 * tok * (2 * h * h + 2 * h * kv + 3 * h * m)
                       + 2 * batch * h * L * (L + 1))
  return nbytes * n_bytes, flops
