"""Full-model checkpoint assembly (port of
carla_garage_tpu/convert/assemble.py): one reference ``model_*.pth``
state dict -> one state dict of ``LidarCenterNet(cfg, norm="bn_affine")``.

The reference loads a pretrained TransFuser++ ensemble by globbing
``model_*.pth`` files next to a ``config.pickle`` and merging that config
over its defaults. ``load_ensemble_directory`` does the same and returns
(TransfuserConfig, [state dicts]), which drop into
``make_transfuser_policy(model, params=[...])``.

Key layouts handled beyond ``torch_import``'s primitives:
  * timm RegNetY (features_only keeps the original module names), 1-based:
      stem.conv / stem.bn
      s{1..4}.b{1..N}.conv1.{conv,bn} / conv2.{conv,bn} / se.{fc1,fc2}
                     .conv3.{conv,bn} / downsample.{conv,bn}
    -> the port's 0-based stem / stage{i}.b{j} / conv{k} / norm{k} / se /
    down_*, every BatchNorm folded into a ``ChannelAffineNorm`` (the model
    must be built with norm="bn_affine");
  * the TransfuserBackbone wiring: transformers.{i} (GPT) with
    lidar_channel_to_img.{i} / img_channel_to_lidar.{i} -> fusion{i}.gpt /
    .lidar_to_img / .img_to_lidar; c5_conv / up_conv5 / up_conv4 as named;
  * the LidarCenterNet heads: join (nn.TransformerDecoder) with
    checkpoint_query, checkpoint_decoder, target_speed_network,
    extra_sensor_encoder + extra_sensor_pos_embed + velocity_normalization,
    the semantic / depth / BEV-semantic decoders and the CenterNet head.
"""

from __future__ import annotations

import glob
import os
import pickle

import torch

from carla_garage_tpu_torch.convert import torch_import as ti
from carla_garage_tpu_torch.convert.torch_import import nest
from carla_garage_tpu_torch.models.transfuser import TransfuserConfig


def sub_dict(sd, prefix):
  """Restrict a state dict to the keys under `prefix.`, prefix removed."""
  p = prefix + "."
  return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def infer_regnety_depths(sd, prefix):
  """Per-stage block counts read off the state dict's keys, robust against
  a config.pickle whose arch string disagrees with the stored weights."""
  depths = []
  for si in range(4):
    bi = 0
    while f"{prefix}.s{si + 1}.b{bi + 1}.conv1.conv.weight" in sd:
      bi += 1
    depths.append(bi)
  return tuple(depths)


def convert_regnety(sd, prefix, depths=None):
  """A timm RegNetY branch -> ``RegNetY(norm="bn_affine")`` keys
  (stem.*, stage{i}.b{j}.*), BatchNorms folded."""
  if depths is None:
    depths = infer_regnety_depths(sd, prefix)
  out = {**nest("stem.conv", ti.conv2d(sd, f"{prefix}.stem.conv")),
         **nest("stem.norm", ti.batchnorm_scale_bias(sd,
                                                     f"{prefix}.stem.bn"))}
  for si, depth in enumerate(depths):
    for bi in range(depth):
      bp = f"{prefix}.s{si + 1}.b{bi + 1}"
      blk = {}
      for k in (1, 2, 3):
        blk.update(nest(f"conv{k}", ti.conv2d(sd, f"{bp}.conv{k}.conv")))
        blk.update(nest(f"norm{k}", ti.batchnorm_scale_bias(
            sd, f"{bp}.conv{k}.bn")))
      blk.update(nest("se.fc1", ti.conv2d(sd, f"{bp}.se.fc1")))
      blk.update(nest("se.fc2", ti.conv2d(sd, f"{bp}.se.fc2")))
      if f"{bp}.downsample.conv.weight" in sd:
        blk.update(nest("down_conv", ti.conv2d(sd,
                                               f"{bp}.downsample.conv")))
        blk.update(nest("down_norm", ti.batchnorm_scale_bias(
            sd, f"{bp}.downsample.bn")))
      out.update(nest(f"stage{si}.b{bi}", blk))
  return out


def convert_transfuser_backbone(sd, cfg: TransfuserConfig,
                                prefix: str = "backbone",
                                n_fusion_stages: int = 4):
  """reference transfuser.TransfuserBackbone -> TransfuserBackbone keys."""
  out = {}
  for ours, theirs in (("image", "image_encoder"), ("lidar", "lidar_encoder")):
    for k, v in convert_regnety(sd, f"{prefix}.{theirs}").items():
      head, rest = k.split(".", 1)        # stem / stage{i}
      out[f"{ours}_{head}.{rest}"] = v
  for i in range(n_fusion_stages):
    out.update(nest(f"fusion{i}", {
        **nest("lidar_to_img", ti.conv2d(
            sd, f"{prefix}.lidar_channel_to_img.{i}")),
        **nest("img_to_lidar", ti.conv2d(
            sd, f"{prefix}.img_channel_to_lidar.{i}")),
        **nest("gpt", ti.convert_gpt(sd, f"{prefix}.transformers.{i}",
                                     cfg.n_fusion_layers)),
    }))
  for name in ("c5_conv", "up_conv5", "up_conv4"):
    out.update(nest(name, ti.conv2d(sd, f"{prefix}.{name}")))
  return out


def convert_lidar_centernet(sd, cfg: TransfuserConfig):
  """One reference LidarCenterNet state dict (the transformer-decoder join
  configuration) -> a state dict for ``LidarCenterNet(cfg,
  norm="bn_affine")``, loadable with strict ``load_state_dict``.

  With cfg.use_wp_gru the reference routes wp_query through the same
  decoder weights; the port's join_wp is a copy of join with wp_query as
  its queries."""
  p = nest("backbone", convert_transfuser_backbone(sd, cfg))
  p.update(nest("change_channel", ti.conv2d(sd, "change_channel")))
  p.update(nest("extra_fc1", ti.linear(sd, "extra_sensor_encoder.0")))
  p.update(nest("extra_fc2", ti.linear(sd, "extra_sensor_encoder.2")))
  p["extra_sensor_pos_embed"] = ti.t2t(sd["extra_sensor_pos_embed"])
  p.update(nest("velocity_norm", ti.batchnorm_scale_bias(
      sd, "velocity_normalization")))
  join = ti.convert_transformer_decoder(
      sd, "join", cfg.n_decoder_layers, queries_key="checkpoint_query")
  p.update(nest("join", join))
  p.update(nest("checkpoint_decoder", ti.convert_gru_interfuser(
      sd, "checkpoint_decoder", target_point_size=2)))
  p.update(nest("target_speed_fc1", ti.linear(sd, "target_speed_network.0")))
  p.update(nest("target_speed_head", ti.linear(sd,
                                               "target_speed_network.2")))
  if cfg.use_wp_gru and "wp_query" in sd:
    join_wp = {k: v.clone() for k, v in join.items()}
    join_wp["queries"] = ti.t2t(sd["wp_query"])
    p.update(nest("join_wp", join_wp))
    p.update(nest("wp_decoder", ti.convert_gru_interfuser(
        sd, "wp_decoder", target_point_size=2)))
  if cfg.use_semantic and "semantic_decoder.deconv1.0.weight" in sd:
    p.update(nest("semantic_decoder", ti.convert_perspective_decoder(
        sd, "semantic_decoder")))
  if cfg.use_depth and "depth_decoder.deconv1.0.weight" in sd:
    p.update(nest("depth_decoder", ti.convert_perspective_decoder(
        sd, "depth_decoder")))
  if cfg.use_bev_semantic and "bev_semantic_decoder.0.weight" in sd:
    p.update(nest("bev_semantic_conv", ti.conv2d(sd,
                                                 "bev_semantic_decoder.0")))
    p.update(nest("bev_semantic_head", ti.conv2d(sd,
                                                 "bev_semantic_decoder.2")))
  if cfg.detect_boxes:
    p.update(nest("centernet", ti.convert_centernet_head(sd, "head")))
  return p


def transfuser_config_from_reference(ref_cfg_attrs: dict) -> TransfuserConfig:
  """A TransfuserConfig from a reference config.pickle's attribute dict,
  merged over the defaults (the pickle's values win). Each field names the
  reference GlobalConfig attribute it comes from."""
  g = ref_cfg_attrs.get
  kw = {}
  kw["image_arch"] = g("image_architecture", "regnety_032")
  kw["lidar_arch"] = g("lidar_architecture", "regnety_032")
  kw["img_h"] = g("camera_height", 256)
  kw["img_w"] = g("camera_width", 1024)
  kw["lidar_h"] = g("lidar_resolution_height", 256)
  kw["lidar_w"] = g("lidar_resolution_width", 256)
  # the LiDAR encoder's in_chans = 1 + use_ground_plane
  kw["lidar_channels"] = 1 + int(g("use_ground_plane", False))
  kw["n_head"] = g("n_head", 4)
  kw["n_fusion_layers"] = g("n_layer", 2)
  kw["img_anchors"] = (g("img_vert_anchors", kw["img_h"] // 32),
                       g("img_horz_anchors", kw["img_w"] // 32))
  kw["lidar_anchors"] = (g("lidar_vert_anchors", kw["lidar_h"] // 32),
                         g("lidar_horz_anchors", kw["lidar_w"] // 32))
  kw["bev_features_channels"] = g("bev_features_chanels", 64)  # sic
  kw["d_model"] = g("gru_input_size", 256)
  kw["n_decoder_heads"] = g("num_decoder_heads", 8)
  kw["n_decoder_layers"] = g("num_transformer_decoder_layers", 6)
  kw["pred_len"] = g("pred_len", 8)
  kw["checkpoint_len"] = g("predict_checkpoint_len", 10)
  kw["gru_hidden"] = g("gru_hidden_size", 64)
  kw["num_semantic"] = len(g("semantic_weights", [0] * 7))
  kw["num_bev_semantic"] = len(g("bev_semantic_weights", [0] * 11))
  kw["num_bb_classes"] = g("num_bb_classes", 4)
  kw["num_dir_bins"] = g("num_dir_bins", 12)
  kw["target_speed_bins"] = len(g("target_speeds", [0] * 4))
  kw["use_wp_gru"] = bool(g("use_wp_gru", False))
  kw["use_controller_input_prediction"] = bool(
      g("use_controller_input_prediction", True))
  kw["use_velocity"] = bool(g("use_velocity", True))
  kw["use_semantic"] = bool(g("use_semantic", True))
  kw["use_depth"] = bool(g("use_depth", True))
  kw["use_bev_semantic"] = bool(g("use_bev_semantic", True))
  kw["detect_boxes"] = bool(g("detect_boxes", True))
  # the detection head's velocity / brake branches exist only for temporal
  # configurations
  kw["bb_velocity_brake"] = not (g("lidar_seq_len", 1) == 1 and
                                 g("seq_len", 1) == 1)
  kw["normalize_imagenet"] = bool(g("normalize_imagenet", True))
  return TransfuserConfig(**kw)


def load_ensemble_directory(path: str):
  """A reference pretrained-model directory -> (TransfuserConfig, [state
  dicts]): read ``config.pickle`` (a dict, or an object whose attributes
  are read; unpickling a reference GlobalConfig needs the reference's
  ``config`` module), merge it over the defaults, then convert every
  ``model_*.pth`` in sorted order. The state dicts are on the CPU; the
  policy's model carries them to its device."""
  cfg_path = os.path.join(path, "config.pickle")
  attrs = {}
  if os.path.exists(cfg_path):
    with open(cfg_path, "rb") as f:
      loaded = pickle.load(f)
    attrs = loaded if isinstance(loaded, dict) else vars(loaded)
  tcfg = transfuser_config_from_reference(attrs)
  params = []
  for f in sorted(glob.glob(os.path.join(path, "model_*.pth"))):
    sd = torch.load(f, map_location="cpu", weights_only=True)
    params.append(convert_lidar_centernet(sd, tcfg))
  if not params:
    raise FileNotFoundError(f"no model_*.pth under {path}")
  return tcfg, params
