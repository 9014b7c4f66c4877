"""Kimi-VL-A3B (``models/kimi_vl.py``: MoonViT, the projector and the
DeepSeek-V3-style decoder with latent attention and a mixture of experts,
``models/mla.py`` and ``models/moe.py``, with SimLingo's driving glue) on
the CPU at small sizes with seeded random weights (one torch thread), held
against direct formulas and the plain reference
``portbench/reference/kimi_vl.py``:

  * the router, the sorted dispatch and the experts against a per-token
    sum written out, with an empty expert and every token on one expert;
  * latent attention against a direct softmax of its written-out
    equations, and its causal mask;
  * MoonViT's 2D RoPE and its interpolated position table against the
    reference's complex-number form and ``F.interpolate``;
  * the whole model against the reference in float32, within a tolerance
    that the bf16 forward fails;
  * the published parameter counts, on the meta device, and the program's
    and the reference's layouts;
  * closed-loop ticks of the camera-only sensor policy with the whole
    frame at native resolution.
"""

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from carla_garage_tpu_torch.agents import sensor_agent as sa
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.models import kimi_vl, mla, moe, vla
from carla_garage_tpu_torch.sim.episode import sim_step
from carla_garage_tpu_torch.sim.scene_builder import make_synthetic_batch
from portbench.reference import kimi_vl as ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = json.loads((ROOT / "portbench/configs/kimi_vl.json").read_text()
                   )["test_small"]["model"]
C = kimi_vl.KimiVLConfig(**SMALL)
# float32 against float32: the program's fused attention, grouped expert
# outputs and float32 stream sum in other orders than the reference's
# matmuls, about 1e-6 of the outputs' scale; a forward in bf16 is off by
# about 1e-2
FLOAT32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def seeded_spec(spec: list, seed: int) -> dict:
  """A state dict in the published layout drawn from `seed`: matrices
  scaled to variance 1/fan-in, norms' gains near 1, the rest small."""
  g = torch.Generator().manual_seed(seed)
  sd = {}
  for name, shape in spec:
    u = torch.rand(shape, generator=g) * 2 - 1
    if len(shape) >= 2:
      u = u * (3.0 / np.prod(shape[1:])) ** 0.5
    elif name.endswith("weight"):
      u = 1 + 0.1 * u
    else:
      u = 0.1 * u
    sd[name] = u
  return sd


def pair(seed: int = 0):
  """The program's and the reference's small model with one state dict
  (the program's experts stacked from the reference's)."""
  r = ref.model(ref.KimiConfig(**SMALL)).eval()
  spec = [(n, tuple(p.shape)) for n, p in r.named_parameters()]
  sd = seeded_spec(spec, seed)
  r.load_state_dict(sd)
  prog = kimi_vl.KimiVL(C).load_published(sd.__getitem__).eval()
  return prog, r


def inputs(B: int = 2, seed: int = 1):
  g = torch.Generator().manual_seed(seed)
  frames = torch.randn(B, 3, C.camera_height, C.camera_width, generator=g)
  tps = torch.randn(B, 2, 2, generator=g) * 10
  speed = torch.rand(B, generator=g) * 8
  cmd = F.one_hot(torch.arange(B) % 6, 6).float()
  return frames, tps, speed, cmd


def rel(got, want) -> float:
  return float((got - want).abs().max() / want.abs().max())


# --- the mixture of experts ---------------------------------------------------

def small_moe(seed: int = 0) -> moe.MoE:
  torch.manual_seed(seed)
  layer = moe.MoE(C.hidden_size, C.n_routed_experts, C.num_experts_per_tok,
                  C.moe_intermediate_size, C.n_shared_experts,
                  C.routed_scaling_factor).eval().requires_grad_(False)
  with torch.no_grad():
    for p in layer.parameters():
      p.uniform_(-1, 1).mul_((3.0 / p.shape[-1]) ** 0.5)
  return layer


def moe_by_hand(layer: moe.MoE, x):
  """Each token's output written out: the sigmoid scores, the top k of
  score + bias, their scores over their sum times the scale, the chosen
  experts' SwiGLU each weighted, and the shared SwiGLU."""
  W = layer.experts.down.shape[-1]
  g = layer.gate
  out = torch.zeros(x.shape[0], x.shape[1], dtype=torch.float64)
  for t in range(x.shape[0]):
    xt = x[t].double()
    s = torch.sigmoid(g.weight.double() @ xt)
    chosen = torch.argsort(s + g.e_score_correction_bias.double(),
                           descending=True)[:layer.top_k]
    w = s[chosen] / s[chosen].sum() * g.scale
    for e, we in zip(chosen.tolist(), w):
      h = layer.experts.gate_up[e].double() @ xt
      a = F.silu(h[:W]) * h[W:]
      out[t] += we * (layer.experts.down[e].double() @ a)
    sh = layer.shared_experts
    out[t] += sh.down_proj.weight.double() @ (
        F.silu(sh.gate_proj.weight.double() @ xt) *
        (sh.up_proj.weight.double() @ xt))
  return out


@pytest.mark.parametrize("spread", ["random", "one_expert_empty",
                                    "all_on_the_same"])
def test_moe_is_each_tokens_sum_over_its_experts(spread):
  layer = small_moe()
  x = torch.randn(37, C.hidden_size, generator=torch.Generator()
                  .manual_seed(3))
  with torch.no_grad():
    if spread == "one_expert_empty":
      layer.gate.e_score_correction_bias[3] = -10.0
    elif spread == "all_on_the_same":
      layer.gate.e_score_correction_bias[:C.num_experts_per_tok] += 10.0
    load = torch.zeros(C.n_routed_experts, dtype=torch.int64)
    routes = torch.zeros(37, C.num_experts_per_tok, dtype=torch.int64)
    got = layer(x, load=load, routes=routes)
  assert got.dtype == torch.float32
  assert float((got.double() - moe_by_hand(layer, x)).abs().max()) < 1e-4
  # every token routed to k distinct experts, counted once each
  assert int(load.sum()) == 37 * C.num_experts_per_tok
  assert all(len(set(r)) == C.num_experts_per_tok for r in routes.tolist())
  assert torch.equal(load, torch.bincount(routes.flatten(),
                                          minlength=C.n_routed_experts))
  if spread == "one_expert_empty":
    assert load[3] == 0
  if spread == "all_on_the_same":
    assert load[:C.num_experts_per_tok].tolist() == \
        [37] * C.num_experts_per_tok


def test_dispatch_sorts_pairs_by_expert_with_offsets():
  ids = torch.tensor([[2, 0], [2, 5], [0, 2], [7, 5]])
  order, counts, ends = moe.dispatch(ids, 8)
  flat = ids.flatten()
  assert flat[order].tolist() == [0, 0, 2, 2, 2, 5, 5, 7]
  # stable: within an expert, the pairs in token order
  assert order.tolist() == [1, 4, 0, 2, 5, 3, 7, 6]
  assert counts.tolist() == [2, 0, 3, 0, 0, 2, 0, 1]
  assert ends.tolist() == [2, 2, 5, 5, 5, 7, 7, 8]


def test_grouped_path_is_not_taken_on_the_cpu():
  x = torch.zeros(4, 8, dtype=torch.bfloat16)
  assert not moe.grouped_available(x)


# --- latent attention -----------------------------------------------------------

def test_mla_is_its_written_out_equations():
  torch.manual_seed(4)
  c = C
  att = mla.MLA(c.hidden_size, c.num_attention_heads, c.qk_nope_head_dim,
                c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank,
                c.rms_norm_eps).eval().requires_grad_(False)
  B, L = 2, 9
  x = torch.randn(B, L, c.hidden_size)
  dr = c.qk_rope_head_dim
  cos, sin = vla.rope_cos_sin(L, dr, c.rope_theta, "cpu", torch.float32)
  got = att(x, cos, sin)
  n, dn, dv = c.num_attention_heads, c.qk_nope_head_dim, c.v_head_dim
  want = torch.empty_like(got)
  for b in range(B):
    q = (x[b] @ att.q_proj.weight.t()).view(L, n, dn + dr)
    kv_a = x[b] @ att.kv_a_proj_with_mqa.weight.t()
    lat, k_pe = kv_a[:, :c.kv_lora_rank], kv_a[:, c.kv_lora_rank:]
    lat = lat / torch.sqrt(lat.pow(2).mean(-1, keepdim=True) +
                           c.rms_norm_eps) * att.kv_a_layernorm.weight
    kv = (lat @ att.kv_b_proj.weight.t()).view(L, n, dn + dv)

    def turn(v, p):
      """Pair i of the interleaved rope dimensions turned by p theta^(-2i
      / dr), laid out as DeepSeek's de-interleaved rotate-half."""
      a, bb = v[..., 0::2], v[..., 1::2]
      ang = p * c.rope_theta ** (-torch.arange(0, dr, 2).float() / dr)
      return torch.cat([a * torch.cos(ang) - bb * torch.sin(ang),
                        bb * torch.cos(ang) + a * torch.sin(ang)], -1)
    o = torch.zeros(L, n, dv)
    for h in range(n):
      for i in range(L):
        qi = torch.cat([q[i, h, :dn], turn(q[i, h, dn:], i)])
        s = torch.stack([qi @ torch.cat([kv[j, h, :dn], turn(k_pe[j], j)])
                         for j in range(i + 1)]) / math.sqrt(dn + dr)
        o[i, h] = torch.softmax(s, 0) @ kv[:i + 1, h, dn:]
    want[b] = o.reshape(L, n * dv) @ att.o_proj.weight.t()
  assert rel(got, want) < 1e-5


def test_mla_hides_every_later_token():
  torch.manual_seed(5)
  c = C
  att = mla.MLA(c.hidden_size, c.num_attention_heads, c.qk_nope_head_dim,
                c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank,
                c.rms_norm_eps).eval().requires_grad_(False)
  L = 10
  cos, sin = vla.rope_cos_sin(L, c.qk_rope_head_dim, c.rope_theta, "cpu",
                              torch.float32)
  x = torch.randn(1, L, c.hidden_size)
  y = x.clone()
  y[:, 6:] = torch.randn(1, L - 6, c.hidden_size)
  a, b = att(x, cos, sin), att(y, cos, sin)
  assert torch.equal(a[:, :6], b[:, :6])
  assert not torch.allclose(a[:, 6:], b[:, 6:])


# --- MoonViT --------------------------------------------------------------------

def test_rope2d_turns_pairs_by_column_and_row():
  rows, cols, d = 3, 5, 16
  cos, sin = kimi_vl.rope2d_cos_sin(rows, cols, d, 10000.0, "cpu")
  x = torch.randn(2, rows * cols, d, dtype=torch.float32)
  got = kimi_vl.apply_rope2d(x, cos, sin)
  want = ref.apply_rope2d(x, ref.rope2d_freqs(rows, cols, d, 10000.0,
                                              "cpu"))
  assert torch.allclose(got, want, atol=1e-6)
  # pair 2i by the column, pair 2i + 1 by the row, at frequency i
  p = 2 * cols + 3                       # row 2, column 3
  for j in range(d // 2):
    i, pos = j // 2, (3 if j % 2 == 0 else 2)
    ang = pos * 10000.0 ** (-4 * i / d)
    a, b = x[0, p, 2 * j], x[0, p, 2 * j + 1]
    assert float(got[0, p, 2 * j]) == pytest.approx(
        float(a * math.cos(ang) - b * math.sin(ang)), abs=1e-5)
    assert float(got[0, p, 2 * j + 1]) == pytest.approx(
        float(a * math.sin(ang) + b * math.cos(ang)), abs=1e-5)


def test_position_table_is_interpolated_to_the_patch_grid():
  prog, r = pair()
  frames = inputs()[0]
  with torch.no_grad():
    got = prog.vision_tower.patch_embed(frames)
    w = r.vision_tower.patch_embed.pos_emb.weight
    rows, cols = C.grid
    table = F.interpolate(w.permute(2, 0, 1)[None], size=(rows, cols),
                          mode="bicubic")[0].permute(1, 2, 0)
    patches = r.vision_tower.patch_embed.proj(frames).flatten(2) \
        .transpose(1, 2)
  assert (rows, cols) != tuple(w.shape[:2])
  assert torch.allclose(got, patches + table.reshape(rows * cols, -1),
                        atol=1e-6)


def test_vision_tower_and_merge_match_the_reference():
  prog, r = pair()
  frames = inputs()[0]
  with torch.no_grad():
    got = prog.image_tokens(frames)
    want = r.image_embeds(frames)
  assert got.shape == (2, C.image_tokens, C.hidden_size)
  assert rel(got, want) < FLOAT32_TOL


def test_camera_native_is_siglip_normalised():
  rgb = torch.rand(2, C.camera_height, C.camera_width, 3)
  got = sa.camera_native(rgb)
  assert got.shape == (2, 3, C.camera_height, C.camera_width)
  assert torch.equal(got, ref.frames(rgb))
  assert torch.allclose(got, rgb.permute(0, 3, 1, 2) * 2 - 1, atol=1e-6)
  assert torch.equal(sa.camera_inputs(rgb, C), got)


# --- the whole model --------------------------------------------------------------

def test_forward_matches_the_reference_and_bf16_does_not():
  prog, r = pair()
  x = inputs()
  with torch.no_grad():
    got, want = prog(*x), r(*x)
    low = kimi_vl.KimiVL(C).load_published(
        dict(r.named_parameters()).__getitem__, torch.bfloat16).eval()
    low_out = low(*(t.to(torch.bfloat16) for t in x))
  assert set(got) == {"pred_path", "pred_wp"}
  assert got["pred_path"].shape == (2, C.path_points, 2)
  assert got["pred_wp"].shape == (2, C.speed_points, 2)
  for k in got:
    assert rel(got[k], want[k]) < FLOAT32_TOL, k
  assert max(rel(low_out[k].float(), want[k]) for k in got) > FLOAT32_TOL
  # the routers stay float32 in the bf16 model; the rest is bf16
  assert all(layer.mlp.gate.weight.dtype == torch.float32
             for layer in low.language_model.layers if layer.moe)
  assert low.vision_tower.encoder.blocks[0].wqkv.weight.dtype == \
      torch.bfloat16


def test_forward_counts_the_experts_load_and_keeps_routes():
  prog, _ = pair()
  B = 2
  with torch.no_grad():
    prog(*inputs(B))
    prog(*inputs(B, seed=2))
  pairs = B * C.seq_len * C.num_experts_per_tok
  assert prog.expert_load.shape == (C.moe_layers, C.n_routed_experts)
  assert prog.expert_load.sum(1).tolist() == [2 * pairs] * C.moe_layers
  assert prog.routes.shape == (C.moe_layers, B * C.seq_len,
                               C.num_experts_per_tok)
  from carla_garage_tpu_torch.utils import profiling
  assert profiling.counters()["model.moe.expert_load"] is prog.expert_load


def test_published_parameter_counts_and_layout():
  with torch.device("meta"):
    m = kimi_vl.KimiVL(kimi_vl.KimiVLConfig())
    r = ref.model(ref.KimiConfig())
  n = lambda mod: sum(p.numel() for p in mod.parameters())
  assert n(m.vision_tower) == 416_866_032
  assert n(m.multi_modal_projector) == 30_679_808
  assert n(m.language_model) == 15_624_565_888
  assert n(m) == n(r) == 16_080_580_212
  assert sum(p.numel() for name, p in m.named_parameters()
             if ".experts." in name) == 14_394_851_328
  assert dict(m.published_spec()) == {k: tuple(p.shape)
                                      for k, p in r.named_parameters()}
  assert kimi_vl.KimiVLConfig().seq_len == 583
  assert kimi_vl.KimiVLConfig().image_tokens == 512


# --- the sensor policy -------------------------------------------------------------

def small_scene(B: int = 2):
  cfg = DEFAULT_CONFIG.replace(sim=dataclasses.replace(DEFAULT_CONFIG.sim,
                                                       max_vehicles=8))
  _, maps, lanes, scene, state = make_synthetic_batch(
      cfg, batch=B, seed=0, n_vehicles=4, n_walkers=2, device="cpu")
  return cfg, maps, lanes, scene, state


def test_closed_loop_ticks_take_the_whole_frame(monkeypatch):
  cfg, maps, lanes, scene, state = small_scene()
  prog, _ = pair()
  grids = sa.sensor_grids(cfg, C, lidar_decimate=16)
  assert grids[0].shape[:2] == (C.camera_height, C.camera_width)
  policy, reset = sa.make_sensor_policy(prog, None, C, grids)
  state = state.replace(agent=reset(cfg, 2, device="cpu"))

  def no_voxels(*a, **k):
    raise AssertionError("a camera-only model voxelizes no LiDAR")

  def no_tiles(*a, **k):
    raise AssertionError("MoonViT takes the frame whole")

  monkeypatch.setattr(sa, "voxelize", no_voxels)
  monkeypatch.setattr(sa, "camera_tiles", no_tiles)
  seen = []
  prog.register_forward_hook(lambda m, a, o: seen.append((a, o)))
  gen = torch.Generator().manual_seed(0)
  for _ in range(3):
    state = sim_step(cfg, maps, lanes, scene, state, policy, generator=gen)
  assert len(seen) == 3
  frames, tps, speed, cmd = seen[0][0]
  assert frames.shape == (2, 3, C.camera_height, C.camera_width)
  assert tps.shape == (2, 2, 2) and cmd.shape == (2, 6)
  assert float(frames.min()) >= -1.0 and float(frames.max()) <= 1.0
  assert all(torch.isfinite(v).all() for _, o in seen for v in o.values())
  assert bool((state.tick == 3).all())


def test_bf16_policy_runs_a_model_placed_in_bf16_as_it_is():
  prog, r = pair()
  low = kimi_vl.KimiVL(C).load_published(r.state_dict().__getitem__,
                                         torch.bfloat16)
  assert low.bf16_placed and not prog.bf16_placed
  assert low.language_model.layers[1].mlp.gate.weight.dtype == torch.float32
  assert sa._members(low, None, bf16=True)[0] is low
  cast = sa._members(prog, None, bf16=True)[0]
  assert cast is not prog
  assert cast.multi_modal_projector.linear_1.weight.dtype == torch.bfloat16
  with pytest.raises(ValueError):
    sa._members(low, [{}], bf16=True)
