"""SimLingo (``models/vla.py``: InternVL2-1B's vision tower, projector and
Qwen2-0.5B decoder with the driving glue) on the CPU at small sizes with
seeded random weights (one torch thread), held against direct formulas
and the plain reference ``portbench/reference/simlingo.py``:

  * rotary positions, grouped-query attention (each key-value head
    repeated for its query heads), the causal mask, InternVL's
    ``pixel_shuffle`` (v2) by its index formula, the tiling and thumbnail
    of a 2:1 frame, and the splice of the image tokens where InternVL puts
    them;
  * the whole model against the reference in float32, within a tolerance
    that the bf16 forward fails;
  * the published parameter counts, on the meta device;
  * a camera-only tick of the sensor policy through ``sim_step`` that
    voxelizes nothing, and its path-and-speed controller by hand;
  * a checkpoint's round trip, and ``run_benchmarks`` driving a tiny
    model from a checkpoint.
"""

import dataclasses
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.agents import sensor_agent as sa
from carla_garage_tpu_torch.agents.controllers import control_pid_direct
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.eval import benchmark
from carla_garage_tpu_torch.models import vla
from carla_garage_tpu_torch.scripts import run_benchmarks as rb
from carla_garage_tpu_torch.sim.episode import sim_step
from carla_garage_tpu_torch.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.utils.checkpoint import (config_from_meta,
                                                     load_checkpoint,
                                                     save_checkpoint)
from port_inputs import write_asset_root
from portbench.reference import simlingo as ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = json.loads((ROOT / "portbench/configs/simlingo.json").read_text()
                   )["test_small"]["model"]
C = vla.SimLingoConfig(**SMALL)
# float32 against float32: the program's fused attention and the
# reference's matmuls sum in other orders, about 1e-6 of the outputs'
# scale; a forward in bf16 is off by about 1e-2
FLOAT32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def seeded(model: torch.nn.Module, seed: int) -> dict:
  """A state dict drawn from `seed`: matrices scaled to variance 1/fan-in,
  norms' gains near 1, the rest small."""
  g = torch.Generator().manual_seed(seed)
  sd = {}
  for name, p in model.state_dict().items():
    u = torch.rand(p.shape, generator=g) * 2 - 1
    if p.ndim >= 2:
      u = u * (3.0 / np.prod(p.shape[1:])) ** 0.5
    elif name.endswith("weight"):
      u = 1 + 0.1 * u
    else:
      u = 0.1 * u
    sd[name] = u
  return sd


def pair(seed: int = 0):
  """The program's and the reference's small model with one state dict."""
  prog = vla.SimLingo(C).eval()
  sd = seeded(prog, seed)
  prog.load_state_dict(sd)
  r = ref.model(ref.VLAConfig(**SMALL)).eval()
  r.load_state_dict(sd)
  return prog, r


def inputs(B: int = 2, seed: int = 1):
  g = torch.Generator().manual_seed(seed)
  tiles = torch.randn(B, C.n_tiles, 3, C.tile, C.tile, generator=g)
  tps = torch.randn(B, 2, 2, generator=g) * 10
  speed = torch.rand(B, generator=g) * 8
  cmd = torch.nn.functional.one_hot(torch.arange(B) % 6, 6).float()
  return tiles, tps, speed, cmd


def rel(got, want) -> float:
  return float((got - want).abs().max() / want.abs().max())


# --- the mechanisms -------------------------------------------------------------

def test_rope_rotates_each_pair_by_its_angle():
  L, D, theta = 7, 8, 1e6
  x = torch.randn(1, 3, L, D, dtype=torch.float64)
  cos, sin = vla.rope_cos_sin(L, D, theta, "cpu", torch.float64)
  got = vla.apply_rope(x, cos, sin)
  want = torch.empty_like(x)
  for p in range(L):
    for i in range(D // 2):
      a = p * theta ** (-2 * i / D)
      x0, x1 = x[..., p, i], x[..., p, i + D // 2]
      want[..., p, i] = x0 * math.cos(a) - x1 * math.sin(a)
      want[..., p, i + D // 2] = x1 * math.cos(a) + x0 * math.sin(a)
  assert torch.allclose(got, want, atol=1e-6)


def plain_attention(q, k, v, causal):
  s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
  if causal:
    L = s.shape[-1]
    s = s.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1),
                      float("-inf"))
  return torch.softmax(s, -1) @ v


def test_gqa_is_attention_with_each_kv_head_repeated():
  torch.manual_seed(0)
  attn = vla.DecoderAttention(C).eval()
  B, L, D = 2, 9, C.hidden // C.heads
  x = torch.randn(B, L, C.hidden)
  cos, sin = vla.rope_cos_sin(L, D, C.rope_theta, "cpu", torch.float32)
  attn.requires_grad_(False)
  got = attn(x, cos, sin)
  rep = C.heads // C.kv_heads
  assert rep == 7                       # Qwen2-0.5B's 14 over 2
  q = vla.apply_rope(attn.q_proj(x).view(B, L, C.heads, D).transpose(1, 2),
                     cos, sin)
  k = vla.apply_rope(attn.k_proj(x).view(B, L, C.kv_heads, D)
                     .transpose(1, 2), cos, sin)
  v = attn.v_proj(x).view(B, L, C.kv_heads, D).transpose(1, 2)
  o = plain_attention(q, k.repeat_interleave(rep, 1),
                      v.repeat_interleave(rep, 1), causal=True)
  want = attn.o_proj(o.transpose(1, 2).reshape(B, L, -1))
  assert rel(got, want) < 1e-5


def test_causal_mask_hides_every_later_token():
  torch.manual_seed(1)
  layer = vla.DecoderLayer(C).eval()
  L, D = 11, C.hidden // C.heads
  cos, sin = vla.rope_cos_sin(L, D, C.rope_theta, "cpu", torch.float32)
  x = torch.randn(1, L, C.hidden)
  y = x.clone()
  y[:, 6:] = torch.randn(1, L - 6, C.hidden)
  a, b = layer(x, cos, sin), layer(y, cos, sin)
  assert torch.equal(a[:, :6], b[:, :6])
  assert not torch.allclose(a[:, 6:], b[:, 6:])


def test_pixel_shuffle_follows_internvl_index_formula():
  n, side, c = 2, 6, 3
  x = torch.arange(n * side * side * c).reshape(n, side, side, c)
  got = vla.pixel_shuffle(x)
  assert got.shape == (n, side // 2, side // 2, 4 * c)
  # out[a2, b2] holds, block q = m // c of its channels, the input token
  # (2 a2 + q // 2, 2 b2 + q % 2)
  for a2 in range(side // 2):
    for b2 in range(side // 2):
      for m in range(4 * c):
        q = m // c
        assert got[1, a2, b2, m] == x[1, 2 * a2 + q // 2, 2 * b2 + q % 2,
                                      m % c]
  assert torch.equal(got, ref.pixel_shuffle_v2(x))


def test_tiles_and_thumbnail_of_a_two_to_one_frame():
  g = torch.Generator().manual_seed(2)
  S = C.tile
  rgb = torch.rand(2, S, 2 * S, 3, generator=g)
  got = sa.camera_tiles(rgb, S)
  assert got.shape == (2, 3, 3, S, S)
  mean = torch.tensor(sa.IMAGENET_MEAN)[:, None, None]
  std = torch.tensor(sa.IMAGENET_STD)[:, None, None]
  x = rgb.permute(0, 3, 1, 2)
  thumb = torch.nn.functional.interpolate(
      x, size=(S, S), mode="bicubic", align_corners=False, antialias=True)
  for i, want in enumerate((x[..., :S], x[..., S:], thumb)):
    assert torch.equal(got[:, i], (want - mean) / std)
  assert torch.equal(got, ref.tiles(rgb, S))
  with pytest.raises(ValueError):
    sa.camera_tiles(torch.rand(1, S, S + 2, 3), S)


def test_splice_puts_the_image_where_internvl_does():
  prog, _ = pair()
  B = 2
  n_img = C.n_tiles * C.tokens_per_tile
  image = torch.randn(B, n_img, C.hidden)
  _, tps, speed, cmd = inputs(B)
  got = prog.embed(image, tps, speed, cmd)
  assert got.shape == (B, C.seq_len, C.hidden)
  table = prog.language_model.embed_tokens
  img_id = ref.img_context_id(ref.VLAConfig(**SMALL))
  for b in range(B):
    ids = prog.template_ids.clone()
    ids[-1] = prog.command_ids[int(cmd[b].argmax())]
    ids = torch.cat([ids[:C.image_at], torch.full((n_img,), img_id),
                     ids[C.image_at:]])
    embeds = table(ids)
    selected = ids == img_id
    embeds[selected] = image[b]                 # InternVL's splice
    n = len(ids)
    assert torch.equal(got[b, :n], embeds)
    assert torch.equal(got[b, n:n + 2], prog.target_point_mlp(tps[b]))
    assert torch.equal(got[b, n + 3:], prog.queries)


# --- the whole model --------------------------------------------------------------

def test_forward_matches_the_reference_and_bf16_does_not():
  prog, r = pair()
  x = inputs()
  with torch.no_grad():
    got, want = prog(*x), r(*x)
    low = prog.to(torch.bfloat16)(*(t.to(torch.bfloat16) for t in x))
  assert set(got) == {"pred_path", "pred_wp"}
  assert got["pred_path"].shape == (2, C.path_points, 2)
  assert got["pred_wp"].shape == (2, C.speed_points, 2)
  for k in got:
    assert rel(got[k], want[k]) < FLOAT32_TOL, k
  assert max(rel(low[k].float(), want[k]) for k in got) > FLOAT32_TOL


def test_bf16_model_keeps_both_residual_streams_in_float32():
  prog, _ = pair()
  prog = prog.to(torch.bfloat16)
  seen = []
  layers = list(prog.vision_model.layers) + list(prog.language_model.layers)
  subs = ([l.attn for l in prog.vision_model.layers]
          + [l.mlp for l in prog.vision_model.layers]
          + [l.self_attn for l in prog.language_model.layers]
          + [l.mlp for l in prog.language_model.layers])
  hooks = [m.register_forward_pre_hook(
      lambda m, a, kind=kind: seen.append((kind, a[0].dtype)))
      for kind, ms in (("stream", layers), ("sublayer", subs)) for m in ms]
  with torch.no_grad():
    out = prog(*(t.to(torch.bfloat16) for t in inputs()))
  for h in hooks:
    h.remove()
  assert {d for k, d in seen if k == "stream"} == {torch.float32}
  assert {d for k, d in seen if k == "sublayer"} == {torch.bfloat16}
  assert len(seen) == 3 * len(layers)
  assert all(v.dtype == torch.bfloat16 for v in out.values())
  # a decoder layer adds its bf16 updates to the stream in float32
  layer = prog.language_model.layers[0]
  x = torch.randn(2, 5, C.hidden) * 30
  cos, sin = vla.rope_cos_sin(5, C.hidden // C.heads, C.rope_theta, "cpu",
                              torch.bfloat16)
  with torch.no_grad():
    h = x + layer.self_attn(layer.input_layernorm(x), cos, sin).float()
    want = h + layer.mlp(layer.post_attention_layernorm(h)).float()
    assert torch.equal(layer(x, cos, sin), want)


def test_published_parameter_counts():
  with torch.device("meta"):
    m = vla.SimLingo(vla.SimLingoConfig())
  n = lambda mod: sum(p.numel() for p in mod.parameters())
  assert n(m.vision_model) == 304_012_288
  assert n(m.mlp1) == 4_482_816
  assert n(m.language_model) == 494_032_768
  assert vla.SimLingoConfig().seq_len == 839


# --- the sensor policy -------------------------------------------------------------

class Fixed(torch.nn.Module):
  """A model that returns given outputs."""

  def __init__(self, out):
    super().__init__()
    self.anchor = torch.nn.Parameter(torch.zeros(1))
    self.out = out
    self.seen = None

  def forward(self, *args):
    self.seen = args
    return self.out


def small_scene(B: int = 2):
  cfg = DEFAULT_CONFIG.replace(sim=dataclasses.replace(DEFAULT_CONFIG.sim,
                                                       max_vehicles=8))
  _, maps, lanes, scene, state = make_synthetic_batch(
      cfg, batch=B, seed=0, n_vehicles=4, n_walkers=2, device="cpu")
  return cfg, maps, lanes, scene, state


def test_camera_only_tick_voxelizes_nothing(monkeypatch):
  cfg, maps, lanes, scene, state = small_scene()
  prog, _ = pair()
  grids = sa.sensor_grids(cfg, C, lidar_decimate=16)
  assert grids[0].shape[:2] == (C.camera_height, C.camera_width)
  policy, reset = sa.make_sensor_policy(prog, None, C, grids)
  state = state.replace(agent=reset(cfg, 2, device="cpu"))

  def no_voxels(*a, **k):
    raise AssertionError("a camera-only model voxelizes no LiDAR")

  monkeypatch.setattr(sa, "voxelize", no_voxels)
  seen = []
  prog.register_forward_hook(lambda m, a, o: seen.append(a))
  nxt = sim_step(cfg, maps, lanes, scene, state, policy,
                 generator=torch.Generator().manual_seed(0))
  tiles, tps, speed, cmd = seen[0]
  assert tiles.shape == (2, 3, 3, C.tile, C.tile)
  assert tps.shape == (2, 2, 2) and cmd.shape == (2, 6)
  # one half sweep kept, for the creep recovery's safety box
  n = grids[1].shape[0] * grids[1].shape[1]
  assert nxt.agent.prev_lidar.shape == (2, 1, n, 3)
  assert bool(nxt.agent.prev_lidar_valid.any())


def test_path_and_speed_control_by_hand():
  cfg, maps, lanes, scene, state = small_scene()
  path = torch.zeros(2, C.path_points, 2)
  path[:, :, 0] = torch.arange(1, C.path_points + 1).float()
  path[0, sa.PATH_AIM] = torch.tensor([3.0, 1.0])     # 18.43 deg left
  path[1, sa.PATH_AIM] = torch.tensor([3.0, -3.0])    # 45 deg right
  wp = torch.zeros(2, C.speed_points, 2)
  wp[0, :, 0] = torch.arange(C.speed_points).float() * 1.5  # 6 m/s
  wp[1, :, 0] = torch.arange(C.speed_points).float() * 0.05  # 0.2 m/s
  model = Fixed({"pred_path": path, "pred_wp": wp})
  grids = sa.sensor_grids(cfg, C, lidar_decimate=16)
  policy, reset = sa.make_sensor_policy(model, None, C, grids)
  ego = state.ego.replace(speed=torch.tensor([3.0, 3.0]))
  state = state.replace(ego=ego, agent=reset(cfg, 2, device="cpu"))
  control, _ = policy(cfg, maps, scene, state,
                      generator=torch.Generator().manual_seed(0))
  # the aim's angle over 90 degrees, and the waypoints' speed: 2 m/s
  # a half second apart, 0 below 0.4 m/s (a brake)
  angle = torch.tensor([math.degrees(math.atan2(1, 3)), -45.0]) / 90.0
  speed = torch.tensor([2 * 1.5 * 2, 0.0])
  ag = state.agent
  steer, throttle, brake, _, _ = control_pid_direct(
      ag.pid_turn, ag.pid_speed, speed, angle, ego.speed, cfg)
  assert torch.allclose(control.steer, steer)
  assert control.steer[0] > 0 > control.steer[1]
  assert torch.equal(control.brake, torch.tensor([0.0, 1.0]))
  assert float(control.throttle[0]) > 0 and float(control.throttle[1]) == 0


# --- checkpoints and the benchmark runner ---------------------------------------

def test_checkpoint_round_trip(tmp_path):
  prog, _ = pair()
  meta = {"model": "simlingo", "config": dataclasses.asdict(C)}
  save_checkpoint(str(tmp_path / "c"), prog, meta=meta)
  _, back = load_checkpoint(str(tmp_path / "c"), meta_only=True)
  got = config_from_meta(json.loads(json.dumps(back)))
  assert type(got) is vla.SimLingoConfig and got == C
  m = vla.SimLingo(got)
  load_checkpoint(str(tmp_path / "c"), m)
  for (k, a), (_, b) in zip(m.state_dict().items(),
                            prog.state_dict().items()):
    assert torch.equal(a, b), k


def test_run_benchmarks_drives_a_tiny_simlingo(tmp_path, monkeypatch):
  root = str(tmp_path / "assets")
  write_asset_root(root)
  monkeypatch.setenv("CGT_TOWN_CACHE", str(tmp_path / "town_cache"))
  monkeypatch.setattr(benchmark, "CARLA_CHUNK", 4)
  prog, _ = pair()
  save_checkpoint(str(tmp_path / "ck"), prog,
                  meta={"model": "simlingo",
                        "config": dataclasses.asdict(C)})
  args = rb.parse_args(["--agent", "simlingo", "--checkpoint",
                        str(tmp_path / "ck"), "--max-ticks", "4",
                        "--n-vehicles", "4", "--towns", "Town01",
                        "--results-dir", str(tmp_path / "out")])
  args.benchmarks = ["longest6"]
  out = rb.run(args, device="cpu", assets_root=root)
  data = json.loads(open(out["longest6"]["json"]).read())
  assert data["meta"]["checkpoint"] == str(tmp_path / "ck")
  assert data["_checkpoint"]["records"]
  assert os.path.basename(out["longest6"]["json"]) == \
      "longest6_simlingo_r1_v4.json"
