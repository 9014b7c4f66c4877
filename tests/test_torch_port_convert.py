"""Port parity: the reference-checkpoint converters, torch vs JAX on the CPU.

Reference-layout state dicts are synthesized here: the timm RegNetY key
layout comes from a stand-in of timm's RegNet (copied from
``tests/test_assemble.py``), every other key follows the reference's
module names (TransfuserBackbone, LidarCenterNet, HuggingFace BERT,
PlanT). All values are drawn from a numpy seed, BatchNorm running
statistics far from the identity.

  * two routes into a micro ``LidarCenterNet(norm="bn_affine")``: JAX's
    ``assemble.convert_lidar_centernet`` then the port's
    ``load_flax_params``, and the port's ``convert_lidar_centernet`` with a
    strict ``load_state_dict``. The weights must be bit-equal (both fold
    the BatchNorms in numpy float32), and each forward
    must match JAX's ``LidarCenterNet(norm="bn_affine")`` within the
    TransFuser model test's bar (1e-4 of max(1, the output's scale)), with
    ``use_wp_gru`` on and off;
  * the regnety_032 key mapping at full size, shapes only;
  * ``transfuser_config_from_reference`` equal to JAX's on several
    attribute dicts, ``{}`` among them;
  * ``load_ensemble_directory`` on a written directory, against JAX's;
  * ``convert_gru_transfuser`` and ``convert_plant`` into the TransFuser
    GRU head and a micro PlanT, each forward against JAX's module on
    JAX's converted params (1e-5, the PlanT test's bar);
  * the slice as a whole: a written two-member micro ensemble loaded by
    both packages and served by each one's sensor policy for 3 ticks of
    ``sim_step``, JAX's draws replayed into the port: every state leaf,
    ints and bools equal, floats to the tick tests' 1e-4.
Torch runs on one thread.
"""

import dataclasses
import functools
import pickle

import jax
import numpy as np
import pytest
import torch
from torch import nn

import carla_garage_tpu.sensors.camera as j_camera
import carla_garage_tpu.sensors.lidar as j_lidar
from carla_garage_tpu.agents import sensor_agent as j_agent
from carla_garage_tpu.config import DEFAULT_CONFIG as JCFG
from carla_garage_tpu.convert import assemble as j_assemble
from carla_garage_tpu.convert import torch_import as j_ti
from carla_garage_tpu.models import plant as j_plant
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.sensors import raycast as j_rc
from carla_garage_tpu.sim import episode as j_episode
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch
from carla_garage_tpu_torch.agents.sensor_agent import (
    make_transfuser_policy, sensor_agent_reset)
from carla_garage_tpu_torch.config import DEFAULT_CONFIG as CFG
from carla_garage_tpu_torch.convert import assemble, load_flax_params
from carla_garage_tpu_torch.convert import torch_import as ti
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.backbones import RegNetY
from carla_garage_tpu_torch.models.plant import PlanT, micro_plant
from carla_garage_tpu_torch.sensors.camera import camera_ray_grid
from carla_garage_tpu_torch.sensors.lidar import lidar_ray_grid
from carla_garage_tpu_torch.sim.episode import sim_step
from carla_garage_tpu_torch.structs import tree_items
from test_torch_port_model import _compare, _inputs
from test_torch_port_plant import close, plant_inputs
from test_torch_port_scene import jax_batch_to_port
from test_torch_port_tick import _draws, _leaf

B = 2
T = lambda a: torch.from_numpy(np.array(a))
MICRO_SPEC = dict(depths=(1, 1, 2, 1), widths=(32, 64, 128, 256),
                  group_w=16, se_ratio=0.25, stem_w=16)
REGNETY_032 = dict(depths=(2, 5, 13, 1), widths=(72, 216, 576, 1512),
                   group_w=24, se_ratio=0.25, stem_w=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


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


# --- the two routes into LidarCenterNet(norm="bn_affine") -------------------

VARIANTS = {
    # the sensor agent's defaults, use_wp_gru on, detection with velocity
    # and brake branches
    "wp_gru": dict(use_wp_gru=True),
    # a pretrained TF++ drop-in: no wp GRU, no velocity / brake branches,
    # ImageNet normalization of 0..255 images
    "drop_in": dict(bb_velocity_brake=False, normalize_imagenet=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_routes_give_equal_weights_and_match_jax(variant):
  jc = dataclasses.replace(jtf.micro_config(), **VARIANTS[variant])
  tc = ttf.TransfuserConfig(**dataclasses.asdict(jc))
  sd = transfuser_reference_sd(jc, seed=1)

  j_params = j_assemble.convert_lidar_centernet(sd, jc)
  via_jax = load_flax_params(ttf.LidarCenterNet(tc, norm="bn_affine"),
                             jax.tree.map(np.asarray, j_params)).eval()
  direct = ttf.LidarCenterNet(tc, norm="bn_affine")
  direct.load_state_dict(assemble.convert_lidar_centernet(sd, tc),
                         strict=True)
  direct.eval()
  a, b = via_jax.state_dict(), direct.state_dict()
  assert set(a) == set(b)
  for k in a:
    assert torch.equal(a[k], b[k]), k
  if variant == "wp_gru":
    assert torch.equal(b["join_wp.layer0.ff1.weight"],
                       b["join.layer0.ff1.weight"])
    assert not torch.equal(b["join_wp.queries"], b["join.queries"])

  x = _inputs(jc, B, seed=2)
  if jc.normalize_imagenet:
    x["rgb"] = x["rgb"] * 255.0
  j_out = jax.jit(jtf.LidarCenterNet(jc, norm="bn_affine").apply)(
      j_params, x["rgb"], x["lidar"], x["tp"], x["cmd"], x["vel"])
  j_out = jax.tree.map(np.asarray, j_out)
  for model in (via_jax, direct):
    with torch.no_grad():
      t_out = model(*(T(x[k]) for k in ("rgb", "lidar", "tp", "cmd",
                                        "vel")))
    _compare(j_out, t_out)
  assert ("pred_wp" in j_out) == jc.use_wp_gru
  assert ("velocity" in j_out["pred_bb"]) == jc.bb_velocity_brake


def test_regnety_032_key_mapping_shapes():
  """The full regnety_032 mapping: every converted key lands on the port's
  RegNetY(norm="bn_affine") (strict), and each has the shape of JAX's
  converted leaf in PyTorch's layout."""
  r = RefDict(3)
  r.timm_regnet("enc", 3, REGNETY_032)
  conv = assemble.convert_regnety(r.sd, "enc")
  assert set(assemble.sub_dict(r.sd, "enc")) == {k[4:] for k in r.sd}
  assert assemble.infer_regnety_depths(r.sd, "enc") == \
      REGNETY_032["depths"]
  RegNetY(norm="bn_affine").load_state_dict(conv, strict=True)
  flat = {}
  j_conv = j_assemble.convert_regnety(r.sd, "enc", REGNETY_032["depths"])
  for path, v in jax.tree_util.tree_flatten_with_path(j_conv)[0]:
    names = [p.key for p in path]
    leaf = {"kernel": "weight"}.get(names[-1], names[-1])
    shape = v.shape if v.ndim != 4 else (v.shape[3], v.shape[2]) + \
        v.shape[:2]
    flat[".".join(names[:-1] + [leaf])] = tuple(shape)
  assert {k: tuple(v.shape) for k, v in conv.items()} == flat
  # 21 blocks of 13 tensors, 4 downsamples of 3, the stem's 3
  assert len(conv) == len(flat) == 21 * 13 + 4 * 3 + 3


REFERENCE_ATTRS = [
    {},
    # the sensor-agent test's reference config
    dict(camera_height=64, camera_width=128, lidar_resolution_height=64,
         lidar_resolution_width=64, img_vert_anchors=2, img_horz_anchors=4,
         lidar_vert_anchors=2, lidar_horz_anchors=2, use_ground_plane=True,
         use_wp_gru=True, normalize_imagenet=False),
    # temporal inputs, other heads and bins, anchors from the image size
    dict(image_architecture="regnety_micro", camera_height=320,
         camera_width=640, lidar_seq_len=2, n_layer=3, n_head=8,
         gru_input_size=128, num_decoder_heads=4,
         num_transformer_decoder_layers=3, predict_checkpoint_len=5,
         semantic_weights=[1.0] * 5, bev_semantic_weights=[1.0] * 9,
         target_speeds=[0.0, 4.0, 8.0, 10.0, 13.0], detect_boxes=0,
         use_semantic=False, bev_features_chanels=32),
]


@pytest.mark.parametrize("attrs", REFERENCE_ATTRS)
def test_transfuser_config_from_reference_matches_jax(attrs):
  got = assemble.transfuser_config_from_reference(attrs)
  want = j_assemble.transfuser_config_from_reference(attrs)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)


# --- the ensemble directory and the slice ------------------------------------

TICK_ATTRS = dict(image_architecture="regnety_micro",
                  lidar_architecture="regnety_micro", camera_height=32,
                  camera_width=128, img_vert_anchors=1, img_horz_anchors=4,
                  lidar_vert_anchors=8, lidar_horz_anchors=8,
                  use_ground_plane=True, gru_input_size=64,
                  num_transformer_decoder_layers=2)


def write_ensemble(path, attrs, n=2):
  """A reference pretrained-model directory: config.pickle (a dict) and
  model_0030.pth, model_0031.pth, ... of different seeds."""
  path.mkdir()
  with open(path / "config.pickle", "wb") as f:
    pickle.dump(attrs, f)
  c = j_assemble.transfuser_config_from_reference(attrs)
  for k in range(n):
    torch.save(transfuser_reference_sd(c, seed=10 + k),
               path / f"model_{30 + k:04d}.pth")


@pytest.fixture(scope="module")
def ensemble_dir(tmp_path_factory):
  d = tmp_path_factory.mktemp("pretrained") / "tfpp"
  write_ensemble(d, TICK_ATTRS)
  return d


def test_load_ensemble_directory_matches_jax(ensemble_dir):
  tcfg, sds = assemble.load_ensemble_directory(str(ensemble_dir))
  jcfg, j_params = j_assemble.load_ensemble_directory(str(ensemble_dir))
  assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
  assert tcfg.lidar_channels == 2 and tcfg.normalize_imagenet
  assert len(sds) == len(j_params) == 2
  for sd, jp in zip(sds, j_params):
    model = ttf.LidarCenterNet(tcfg, norm="bn_affine")
    model.load_state_dict(sd, strict=True)
    via_jax = load_flax_params(ttf.LidarCenterNet(tcfg, norm="bn_affine"),
                               jax.tree.map(np.asarray, jp))
    for k, v in via_jax.state_dict().items():
      assert torch.equal(sd[k], v), k
  assert not torch.equal(sds[0]["change_channel.weight"],
                         sds[1]["change_channel.weight"])
  with pytest.raises(FileNotFoundError):
    assemble.load_ensemble_directory(str(ensemble_dir / "missing"))


@pytest.mark.parametrize("learn_origin", [True, False])
def test_convert_gru_transfuser_matches_jax(learn_origin):
  """A reference GRUWaypointsPredictorTransFuser (a GRUCell wp_decoder and
  an output Linear) into heads.GRUWaypointsPredictorTransFuser."""
  from carla_garage_tpu.models.heads import \
      GRUWaypointsPredictorTransFuser as JHead
  from carla_garage_tpu_torch.models.heads import \
      GRUWaypointsPredictorTransFuser
  r = RefDict(6)
  r.gru("head.wp_decoder", 4, 64, "")
  r.linear("head.output", 2, 64)
  rng = np.random.default_rng(7)
  z = rng.normal(size=(3, 64 + 2 * learn_origin)).astype(np.float32)
  tp = rng.normal(0, 10, (3, 2)).astype(np.float32)
  j_params = j_ti.convert_gru_transfuser(r.sd, "head")
  want = JHead(pred_len=8, learn_origin=learn_origin).apply(
      {"params": j_params}, z, tp)
  head = GRUWaypointsPredictorTransFuser(8, learn_origin=learn_origin)
  head.load_state_dict(ti.convert_gru_transfuser(r.sd, "head"), strict=True)
  with torch.no_grad():
    got = head(T(z), T(tp))
  close(got, want, 1e-5, "waypoints")


def test_convert_plant_matches_jax():
  pc = micro_plant()
  sd = plant_reference_sd(pc, seed=4)
  j_params = j_ti.convert_plant(sd, pc.n_layers, pc.n_heads)
  shapes = jax.eval_shape(j_plant.PlanT(pc).init, jax.random.key(0),
                          *plant_inputs(pc, B, 0))["params"]
  assert jax.tree.structure(j_params) == jax.tree.structure(shapes)
  model = PlanT(pc)
  model.load_state_dict(ti.convert_plant(sd, pc.n_layers), strict=True)
  x = plant_inputs(pc, 3, 5)
  want = jax.jit(j_plant.PlanT(pc).apply)({"params": j_params}, *x)
  with torch.no_grad():
    got = model.eval()(*(T(a) for a in x))
  for k in ("pred_wp", "pred_target_speed", "pred_checkpoint"):
    close(got[k], want[k], 1e-5, k)
  for i, (g, w) in enumerate(zip(got["pred_forecast"],
                                 want["pred_forecast"])):
    close(g, w, 1e-5, f"forecast {i}")


def test_converted_ensemble_drives_sim_step_like_jax(ensemble_dir,
                                                     monkeypatch):
  pallas = functools.partial(j_rc.cast_rays, use_pallas=True)
  monkeypatch.setattr(j_camera, "cast_rays", pallas)
  monkeypatch.setattr(j_lidar, "cast_rays", pallas)
  cam = camera_ray_grid(CFG, scale=8)
  lid_f = lidar_ray_grid(CFG, half=0, decimate=16)
  lid_r = lidar_ray_grid(CFG, half=1, decimate=16)
  n_lidar = lid_f.shape[0] * lid_f.shape[1]
  _, maps, lanes, scene, state = make_synthetic_batch(
      JCFG, batch=B, seed=4, n_vehicles=6, n_walkers=1)

  jcfg, j_params = j_assemble.load_ensemble_directory(str(ensemble_dir))
  j_policy = j_agent.make_transfuser_policy(
      jtf.LidarCenterNet(jcfg, norm="bn_affine"), j_params, jcfg, cam,
      lid_f, lid_r, direct=True)
  j_state = state.replace(agent=j_agent.sensor_agent_reset(JCFG, B, n_lidar))
  j_step = jax.jit(lambda st: j_episode.sim_step(JCFG, maps, lanes, scene,
                                                 st, j_policy))

  tcfg, sds = assemble.load_ensemble_directory(str(ensemble_dir))
  t_policy = make_transfuser_policy(
      ttf.LidarCenterNet(tcfg, norm="bn_affine"), sds, tcfg, cam, lid_f,
      lid_r, direct=True)
  t_maps, t_lanes, t_scene, t_state = jax_batch_to_port(maps, lanes, scene,
                                                        state)
  t_state = t_state.replace(agent=sensor_agent_reset(CFG, B, n_lidar,
                                                     device="cpu"))
  rng = j_state.rng
  for _ in range(3):
    rng, draws = _draws(rng, n_lidar)
    j_state = j_step(j_state)
    t_state = sim_step(CFG, t_maps, t_lanes, t_scene, t_state, t_policy,
                       draws=draws)
    n = 0
    for path, t in tree_items(t_state):
      want, got = _leaf(j_state, path), t.numpy()
      assert got.dtype == want.dtype and got.shape == want.shape, path
      if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=path)
      else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=path)
      n += 1
    assert n > 80
  assert int(t_state.tick.min()) == 3
  assert float(t_state.agent.prev_control[:, 0].abs().max()) > 0.0
