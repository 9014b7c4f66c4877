"""Inputs that the port's CPU tests and its card tests share. This module
imports no JAX, so the card tests can use it where JAX is absent.

- ``write_asset_root`` writes a small asset root in the reference's
  layout (see ``tests/test_torch_port_importer.py``).
- ``transfuser_reference_sd`` and ``plant_reference_sd`` draw state dicts
  in the reference's key layout from a numpy seed: the timm RegNetY keys
  come from a stand-in of timm's RegNet (copied from
  ``tests/test_assemble.py``), every other key follows the reference's
  module names (TransfuserBackbone, LidarCenterNet, HuggingFace BERT,
  PlanT); BatchNorm running statistics far from the identity.
"""

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from carla_garage_tpu_torch.maps import importer, routing
from carla_garage_tpu_torch.maps.synthetic import make_town

TOWNS = {"Town01": dict(n_x=3, n_y=3, yellow=True, offset=(0.0, 0.0)),
         "Town02": dict(n_x=2, n_y=3, yellow=False, offset=(-50.0, -20.0))}


def grid_town_arrays(n_x, n_y, yellow, offset, block=60.0, margin=15.0):
  """(h5 layers, ppm, world_offset, grid town) of a procedural grid town
  whose world is shifted by `offset`: the town's lanes, shifted, are
  lanes of the h5 town."""
  t = make_town(n_x=n_x, n_y=n_y, block=block, margin=margin)
  arrays = importer.grid_town_arrays(n_x=n_x, n_y=n_y, block=block,
                                     margin=margin, yellow=yellow)
  off = np.asarray(offset, np.float32)
  shifted = dataclasses.replace(
      t, lane_polys=[p + off for p in t.lane_polys])
  return arrays, t.ppm, off, shifted


def sample_routes(town, n, seed, min_m=90.0, max_m=200.0):
  """n lane-graph routes (keypoints xy, yaw) whose goal lies 40 m or more
  from their start."""
  rng = np.random.default_rng(seed)
  out = []
  while len(out) < n:
    res = routing.sample_lane_route(town.lane_polys, town.lane_successors,
                                    rng, min_len_m=min_m, max_len_m=max_m)
    if res is not None and np.linalg.norm(res[0][-1] - res[0][0]) > 40.0:
      out.append(res)
  return out


def write_asset_root(root, towns=TOWNS, n_routes=(3, 2), h5=True) -> dict:
  """Write the asset root (see the module docstring). Returns {town:
  (arrays, ppm, world_offset)}. h5=False leaves the town files out."""
  layers, l6, lav, public = {}, [], [], {}
  for ti, (name, spec) in enumerate(towns.items()):
    arrays, ppm, off, town = grid_town_arrays(**spec)
    layers[name] = (arrays, ppm, off)
    if h5:
      importer.write_town_h5(root, name, arrays, ppm, off)
    routes = sample_routes(town, n_routes[ti] + 1, seed=ti)
    for k, (xy, yaw) in enumerate(routes[:-1]):
      l6.append((f"{ti * 10 + k}", name, xy, yaw))
    lav.append((f"{ti * 10 + 9}", name, *routes[-1]))
    # Scenario1/3/4 sites every 8 m or so along every third lane each,
    # facing the lane's travel direction: random routes meet them too
    public[name] = {k: [(float(x), float(y), float(np.degrees(np.arctan2(
        *(p[-1] - p[0])[::-1])))) for p in town.lane_polys[i::3]
        for x, y in p[1:-1:2]]
        for i, k in enumerate(("Scenario1", "Scenario3", "Scenario4"))}
  data = os.path.join(root, importer.ROUTES_DIR)
  importer.write_routes_xml(os.path.join(data, "longest6.xml"), l6)
  importer.write_routes_xml(os.path.join(data, "lav.xml"), lav)
  scen = os.path.join(data, "scenarios")
  importer.write_scenarios_json(
      os.path.join(scen, "all_towns_traffic_scenarios_public.json"), public)
  # Town01: signalized approaches at two junctions, an unsignalized one
  importer.write_scenarios_json(
      os.path.join(scen, "town01_all_scenarios.json"),
      {"Town01": {"Scenario7": [(60.0, 26.0, 90.0), (60.0, 26.0, 90.0)],
                  "Scenario8": [(129.0, 73.25, 180.0)],
                  "Scenario10": [(15.0 + 1.75, 120.0, -90.0)]}})
  # Town02: one blanket site list under every type (no information)
  sites = [(-50.0 + 15.0, -20.0 + 30.0, 90.0),
           (-50.0 + 75.0, -20.0 + 90.0, 0.0)]
  importer.write_scenarios_json(
      os.path.join(scen, "town02_all_scenarios.json"),
      {"Town02": {k: sites for k in ("Scenario7", "Scenario8", "Scenario9",
                                     "Scenario10")}})
  return layers


MICRO_SPEC = dict(depths=(1, 1, 2, 1), widths=(32, 64, 128, 256),
                  group_w=16, se_ratio=0.25, stem_w=16)
REGNETY_032 = dict(depths=(2, 5, 13, 1), widths=(72, 216, 576, 1512),
                   group_w=24, se_ratio=0.25, stem_w=32)


# --- the timm RegNet stand-in (tests/test_assemble.py) ----------------------

class ConvNormAct(nn.Module):
  """timm ConvNormAct: .conv + .bn (+ inline act)."""

  def __init__(self, cin, cout, k=3, stride=1, groups=1, act=True):
    super().__init__()
    self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                          groups=groups, bias=False)
    self.bn = nn.BatchNorm2d(cout)
    self.act = nn.ReLU(inplace=True) if act else nn.Identity()

  def forward(self, x):
    return self.act(self.bn(self.conv(x)))


class SEModule(nn.Module):
  def __init__(self, channels, rd_channels):
    super().__init__()
    self.fc1 = nn.Conv2d(channels, rd_channels, 1, bias=True)
    self.fc2 = nn.Conv2d(rd_channels, channels, 1, bias=True)

  def forward(self, x):
    s = x.mean((2, 3), keepdim=True)
    return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class Bottleneck(nn.Module):
  """timm RegNetY bottleneck (bottle_ratio 1)."""

  def __init__(self, cin, cout, stride, group_w, se_ratio):
    super().__init__()
    groups = max(cout // group_w, 1)
    self.conv1 = ConvNormAct(cin, cout, 1)
    self.conv2 = ConvNormAct(cout, cout, 3, stride=stride, groups=groups)
    self.se = SEModule(cout, max(int(cin * se_ratio), 8))
    self.conv3 = ConvNormAct(cout, cout, 1, act=False)
    if stride != 1 or cin != cout:
      self.downsample = ConvNormAct(cin, cout, 1, stride=stride, act=False)
    else:
      self.downsample = None
    self.act3 = nn.ReLU(inplace=True)

  def forward(self, x):
    sc = x if self.downsample is None else self.downsample(x)
    h = self.conv3(self.se(self.conv2(self.conv1(x))))
    return self.act3(h + sc)


class FakeRegNetFeatures(nn.Module):
  """timm features_only=True stand-in: named children stem / s1..s4."""

  def __init__(self, in_chans=3, spec=MICRO_SPEC):
    super().__init__()
    self.stem = ConvNormAct(in_chans, spec["stem_w"], 3, stride=2)
    cin = spec["stem_w"]
    for si, (d, w) in enumerate(zip(spec["depths"], spec["widths"])):
      blocks = nn.Sequential()
      for bi in range(d):
        blocks.add_module(f"b{bi + 1}", Bottleneck(
            cin, w, 2 if bi == 0 else 1, spec["group_w"], spec["se_ratio"]))
        cin = w
      self.add_module(f"s{si + 1}", blocks)


# --- reference-layout state dicts -------------------------------------------

class RefDict:
  """A reference-layout state dict drawn from a numpy seed."""

  def __init__(self, seed):
    self.rng = np.random.default_rng(seed)
    self.sd = {}

  def put(self, key, shape, kind):
    r = self.rng
    if kind == "weight":          # Linear / conv: N(0, 1/fan_in)
      x = r.normal(0, 1, shape) / np.sqrt(max(np.prod(shape[1:]), 1))
    elif kind == "gamma":
      x = 1.0 + 0.1 * r.normal(size=shape)
    elif kind == "mean":
      x = 0.2 * r.normal(size=shape)
    elif kind == "var":
      x = r.uniform(0.5, 2.0, shape)
    else:                         # biases, embeddings, queries
      x = 0.05 * r.normal(size=shape)
    self.sd[key] = torch.tensor(x, dtype=torch.float32)

  def linear(self, p, out, inp):
    self.put(f"{p}.weight", (out, inp), "weight")
    self.put(f"{p}.bias", (out,), "bias")

  def conv(self, p, out, inp, k):
    self.put(f"{p}.weight", (out, inp, k, k), "weight")
    self.put(f"{p}.bias", (out,), "bias")

  def layernorm(self, p, c):
    self.put(f"{p}.weight", (c,), "gamma")
    self.put(f"{p}.bias", (c,), "bias")

  def batchnorm(self, p, c, affine=True):
    if affine:
      self.put(f"{p}.weight", (c,), "gamma")
      self.put(f"{p}.bias", (c,), "bias")
    self.put(f"{p}.running_mean", (c,), "mean")
    self.put(f"{p}.running_var", (c,), "var")
    self.sd[f"{p}.num_batches_tracked"] = torch.tensor(1000)

  def gru(self, p, inp, hidden, suffix):
    for name, shape in ((f"weight_ih{suffix}", (3 * hidden, inp)),
                        (f"weight_hh{suffix}", (3 * hidden, hidden))):
      self.put(f"{p}.{name}", shape, "weight")
    for name in (f"bias_ih{suffix}", f"bias_hh{suffix}"):
      self.put(f"{p}.{name}", (3 * hidden,), "bias")

  def mha(self, p, d):
    self.put(f"{p}.in_proj_weight", (3 * d, d), "weight")
    self.put(f"{p}.in_proj_bias", (3 * d,), "bias")
    self.linear(f"{p}.out_proj", d, d)

  def timm_regnet(self, p, in_chans, spec):
    """The stand-in's keys and shapes, values from the seed."""
    for k, v in FakeRegNetFeatures(in_chans, spec).state_dict().items():
      key = f"{p}.{k}"
      if k.endswith("num_batches_tracked"):
        self.sd[key] = v
      elif k.endswith("running_mean"):
        self.put(key, tuple(v.shape), "mean")
      elif k.endswith("running_var"):
        self.put(key, tuple(v.shape), "var")
      elif ".bn." in k and k.endswith("weight"):
        self.put(key, tuple(v.shape), "gamma")
      elif k.endswith("weight"):
        self.put(key, tuple(v.shape), "weight")
      else:
        self.put(key, tuple(v.shape), "bias")


def transfuser_reference_sd(c, seed, spec=MICRO_SPEC):
  """A reference LidarCenterNet state dict (the transformer-decoder join
  configuration) for TransfuserConfig c."""
  r = RefDict(seed)
  r.timm_regnet("backbone.image_encoder", 3, spec)
  r.timm_regnet("backbone.lidar_encoder", c.lidar_channels, spec)
  n_tok = c.img_anchors[0] * c.img_anchors[1] + \
      c.lidar_anchors[0] * c.lidar_anchors[1]
  for i, w in enumerate(spec["widths"]):
    g = f"backbone.transformers.{i}"
    r.put(f"{g}.pos_emb", (1, n_tok, w), "bias")
    for j in range(c.n_fusion_layers):
      b = f"{g}.blocks.{j}"
      r.layernorm(f"{b}.ln1", w)
      r.layernorm(f"{b}.ln2", w)
      for name in ("query", "key", "value", "proj"):
        r.linear(f"{b}.attn.{name}", w, w)
      r.linear(f"{b}.mlp.0", 4 * w, w)
      r.linear(f"{b}.mlp.2", w, 4 * w)
    r.layernorm(f"{g}.ln_f", w)
    r.conv(f"backbone.lidar_channel_to_img.{i}", w, w, 1)
    r.conv(f"backbone.img_channel_to_lidar.{i}", w, w, 1)
  ch, d, last = c.bev_features_channels, c.d_model, spec["widths"][-1]
  r.conv("backbone.c5_conv", ch, last, 1)
  r.conv("backbone.up_conv5", ch, ch, 3)
  r.conv("backbone.up_conv4", ch, ch, 3)
  r.conv("change_channel", d, last, 1)
  r.linear("extra_sensor_encoder.0", 128, 7)
  r.linear("extra_sensor_encoder.2", d, 128)
  r.put("extra_sensor_pos_embed", (1, d), "bias")
  r.batchnorm("velocity_normalization", 1, affine=False)
  for i in range(c.n_decoder_layers):
    lp = f"join.layers.{i}"
    r.mha(f"{lp}.self_attn", d)
    r.mha(f"{lp}.multihead_attn", d)
    r.linear(f"{lp}.linear1", 2048, d)
    r.linear(f"{lp}.linear2", d, 2048)
    for k in (1, 2, 3):
      r.layernorm(f"{lp}.norm{k}", d)
  r.layernorm("join.norm", d)
  r.put("checkpoint_query", (1, c.checkpoint_len + 1, d), "bias")
  decoders = ["checkpoint_decoder"]
  if c.use_wp_gru:
    r.put("wp_query", (1, c.pred_len, d), "bias")
    decoders.append("wp_decoder")
  for p in decoders:
    r.gru(f"{p}.gru", d, c.gru_hidden, "_l0")
    r.linear(f"{p}.encoder", c.gru_hidden, 2)
    r.linear(f"{p}.decoder", 2, c.gru_hidden)
  r.linear("target_speed_network.0", d, d)
  r.linear("target_speed_network.2", c.target_speed_bins, d)
  for p, n in (("semantic_decoder", c.num_semantic), ("depth_decoder", 1)):
    for k, (o, i) in enumerate(((128, last), (64, 128), (32, 64),
                                (32, 32), (32, 32), (n, 32))):
      r.conv(f"{p}.deconv{k // 2 + 1}.{2 * (k % 2)}", o, i, 3)
  r.conv("bev_semantic_decoder.0", ch, ch, 3)
  r.conv("bev_semantic_decoder.2", c.num_bev_semantic, ch, 1)
  outs = {"heatmap": c.num_bb_classes, "wh": 2, "offset": 2,
          "yaw_class": c.num_dir_bins, "yaw_res": 1}
  if c.bb_velocity_brake:
    outs.update(velocity=1, brake=2)
  for name, n in outs.items():
    r.conv(f"head.{name}_head.0", ch, ch, 3)
    r.conv(f"head.{name}_head.2", n, ch, 1)
  return r.sd


def plant_reference_sd(pc, seed):
  """A reference PlanT state dict (HuggingFace BERT under 'model')."""
  r = RefDict(seed)
  h, A = pc.hidden, pc.num_attributes
  e = "model.embeddings"
  r.put(f"{e}.position_embeddings.weight", (pc.max_positions, h), "bias")
  r.put(f"{e}.token_type_embeddings.weight", (2, h), "bias")
  r.layernorm(f"{e}.LayerNorm", h)
  for i in range(pc.n_layers):
    lp = f"model.encoder.layer.{i}"
    for name in ("query", "key", "value"):
      r.linear(f"{lp}.attention.self.{name}", h, h)
    r.linear(f"{lp}.attention.output.dense", h, h)
    r.layernorm(f"{lp}.attention.output.LayerNorm", h)
    r.linear(f"{lp}.intermediate.dense", pc.intermediate, h)
    r.linear(f"{lp}.output.dense", h, pc.intermediate)
    r.layernorm(f"{lp}.output.LayerNorm", h)
  r.put("cls_emb", (1, A + 1), "gamma")
  r.linear("tok_emb", h, A)
  for i in range(pc.num_types):
    r.put(f"obj_token.{i}", (1, A), "gamma")
    r.linear(f"obj_emb.{i}", h, A)
  for i, v in enumerate(pc.vocab_sizes):
    r.linear(f"heads.{i}", v, h)
  r.linear("velocity_encoder.0", 128, 1)
  r.linear("velocity_encoder.2", 128, 128)
  r.batchnorm("velocity_normalization", 1, affine=False)
  r.linear("wp_head", 64 + 2, h + 128)
  r.gru("wp_decoder", 2 + 3, 64, "")
  r.linear("wp_output", 2, 64)
  r.linear("target_speed_network.0", 128, h + 128 + 3)
  r.linear("target_speed_network.2", pc.target_speed_bins, 128)
  r.gru("checkpoint_decoder.gru", h, pc.gru_hidden, "_l0")
  r.linear("checkpoint_decoder.decoder", 2, pc.gru_hidden)
  return r.sd
