"""Reference PyTorch state dicts -> the port's state dicts (port of
carla_garage_tpu/convert/torch_import.py).

The reference ships its pretrained TransFuser++ and PlanT ensembles as
``model_*.pth`` state dicts. The port's modules are PyTorch too, so this is
a renaming of keys with no transposes: a Linear stays [out, in] and a conv
stays OIHW. What changes besides the names:
  * an inference BatchNorm becomes the (scale, bias) of an affine norm,
    y = (x - mean) / sqrt(var + eps) * gamma + beta with eps 1e-5
    (``batchnorm_scale_bias``; affine=False BatchNorms, such as the
    reference's velocity normalization, take gamma 1 and beta 0);
  * a torch GRU(Cell) becomes the flax-style ``GRUCell`` of
    ``models.heads``: the r and z gates' biases are the sums of torch's two
    biases (the cell's hr and hz have none), while the candidate keeps
    b_in on ``in_`` and b_hn on ``hn``, which r multiplies;
  * nn.MultiheadAttention's packed in_proj splits into query / key / value.
The head count never enters: the port keeps query / key / value as
[C, C] Linears, as torch does, so the converters take no head counts.

Each function returns a dict of the tensors it fills, keyed by the port
module's parameter names relative to that module (float32 copies).
"""

from __future__ import annotations

import numpy as np
import torch


def t2t(x) -> torch.Tensor:
  """A float32 copy of a state-dict entry, on the CPU."""
  return torch.as_tensor(x).detach().to("cpu", torch.float32).clone()


def _k(prefix, name):
  return f"{prefix}.{name}" if prefix else name


def nest(prefix: str, d: dict) -> dict:
  """Put a module's keys under `prefix`."""
  return {_k(prefix, k): v for k, v in d.items()}


def linear(sd, prefix):
  """torch nn.Linear -> the port's Linear (weight [out, in] as it is)."""
  out = {"weight": t2t(sd[_k(prefix, "weight")])}
  if _k(prefix, "bias") in sd:
    out["bias"] = t2t(sd[_k(prefix, "bias")])
  return out


def conv2d(sd, prefix):
  """torch nn.Conv2d -> the port's Conv2d (OIHW as it is)."""
  return linear(sd, prefix)


def layernorm(sd, prefix):
  return {"weight": t2t(sd[_k(prefix, "weight")]),
          "bias": t2t(sd[_k(prefix, "bias")])}


def batchnorm_scale_bias(sd, prefix, eps=1e-5):
  """Inference-mode BatchNorm as an affine norm's (scale, bias), folded in
  numpy float32 as the JAX converter folds it."""
  mean = t2t(sd[_k(prefix, "running_mean")]).numpy()
  var = t2t(sd[_k(prefix, "running_var")]).numpy()
  gamma = t2t(sd[_k(prefix, "weight")]).numpy() \
      if _k(prefix, "weight") in sd else np.ones_like(mean)
  beta = t2t(sd[_k(prefix, "bias")]).numpy() \
      if _k(prefix, "bias") in sd else np.zeros_like(mean)
  scale = gamma / np.sqrt(var + eps)
  return {"scale": torch.from_numpy(scale),
          "bias": torch.from_numpy(beta - mean * scale)}


def gru_cell(sd, prefix, suffix=""):
  """torch GRUCell (weight_ih, ...) or a one-layer GRU (suffix "_l0") ->
  the port's GRUCell (ir, iz, in_, hr, hz, hn)."""
  wih = t2t(sd[_k(prefix, f"weight_ih{suffix}")])          # [3H, in]
  whh = t2t(sd[_k(prefix, f"weight_hh{suffix}")])          # [3H, H]
  bih = t2t(sd[_k(prefix, f"bias_ih{suffix}")])
  bhh = t2t(sd[_k(prefix, f"bias_hh{suffix}")])
  wir, wiz, win = wih.chunk(3)
  whr, whz, whn = whh.chunk(3)
  bir, biz, bin_ = bih.chunk(3)
  bhr, bhz, bhn = bhh.chunk(3)
  return {"ir.weight": wir, "ir.bias": bir + bhr,
          "iz.weight": wiz, "iz.bias": biz + bhz,
          "in_.weight": win, "in_.bias": bin_,
          "hr.weight": whr, "hz.weight": whz,
          "hn.weight": whn, "hn.bias": bhn}


def mha_packed(sd, prefix):
  """torch nn.MultiheadAttention (packed in_proj) -> the port's
  MultiHeadAttention."""
  w = t2t(sd[_k(prefix, "in_proj_weight")])                # [3C, C]
  b = t2t(sd[_k(prefix, "in_proj_bias")])
  out = {}
  for name, wx, bx in zip(("query", "key", "value"), w.chunk(3), b.chunk(3)):
    out[f"{name}.weight"], out[f"{name}.bias"] = wx, bx
  out.update(nest("out", linear(sd, _k(prefix, "out_proj"))))
  return out


def mha_separate(sd, qp, kp, vp, op):
  """Separate q / k / v / out Linears (the reference GPT's SelfAttention,
  HF BERT's self-attention) -> the port's MultiHeadAttention."""
  out = {}
  for name, p in (("query", qp), ("key", kp), ("value", vp), ("out", op)):
    out.update(nest(name, linear(sd, p)))
  return out


# --- module converters (reference module -> carla_garage_tpu_torch.models)

def convert_gpt_block(sd, prefix):
  """reference transfuser.Block -> fusion.SelfAttentionBlock."""
  return {
      **nest("ln1", layernorm(sd, _k(prefix, "ln1"))),
      **nest("ln2", layernorm(sd, _k(prefix, "ln2"))),
      **nest("attn", mha_separate(
          sd, _k(prefix, "attn.query"), _k(prefix, "attn.key"),
          _k(prefix, "attn.value"), _k(prefix, "attn.proj"))),
      **nest("mlp_fc", linear(sd, _k(prefix, "mlp.0"))),
      **nest("mlp_proj", linear(sd, _k(prefix, "mlp.2"))),
  }


def convert_gpt(sd, prefix, n_layer):
  """reference transfuser.GPT -> fusion.GPTFusion."""
  out = {"pos_emb": t2t(sd[_k(prefix, "pos_emb")]),
         **nest("ln_f", layernorm(sd, _k(prefix, "ln_f")))}
  for i in range(n_layer):
    out.update(nest(f"block{i}", convert_gpt_block(
        sd, _k(prefix, f"blocks.{i}"))))
  return out


def convert_gru_interfuser(sd, prefix, target_point_size=2):
  """reference GRUWaypointsPredictorInterFuser ->
  heads.GRUWaypointsPredictorInterFuser."""
  out = {**nest("gru", gru_cell(sd, _k(prefix, "gru"), "_l0")),
         **nest("decoder", linear(sd, _k(prefix, "decoder")))}
  if target_point_size > 0:
    out.update(nest("encoder", linear(sd, _k(prefix, "encoder"))))
  return out


def convert_gru_transfuser(sd, prefix):
  """reference GRUWaypointsPredictorTransFuser ->
  heads.GRUWaypointsPredictorTransFuser."""
  return {**nest("gru", gru_cell(sd, _k(prefix, "wp_decoder"))),
          **nest("decoder", linear(sd, _k(prefix, "output")))}


def convert_centernet_head(sd, prefix=""):
  """reference center_net.LidarCenterNetHead -> heads.CenterNetHead.

  The reference applies the heatmap's sigmoid inside its forward; the
  port's head returns logits (the decode applies the sigmoid). The weights
  are the same."""
  out = {}
  for ours, theirs in [("heatmap", "heatmap_head"), ("wh", "wh_head"),
                       ("offset", "offset_head"),
                       ("yaw_class", "yaw_class_head"),
                       ("yaw_res", "yaw_res_head"),
                       ("velocity", "velocity_head"),
                       ("brake", "brake_head")]:
    if _k(prefix, f"{theirs}.0.weight") not in sd:
      continue
    out.update(nest(f"{ours}_conv", conv2d(sd, _k(prefix, f"{theirs}.0"))))
    out.update(nest(f"{ours}_out", conv2d(sd, _k(prefix, f"{theirs}.2"))))
  return out


def convert_transformer_decoder_layer(sd, prefix):
  """torch nn.TransformerDecoderLayer (post-LN, batch_first) ->
  heads.TransformerDecoderLayer."""
  return {
      **nest("self_attn", mha_packed(sd, _k(prefix, "self_attn"))),
      **nest("cross_attn", mha_packed(sd, _k(prefix, "multihead_attn"))),
      **nest("ln1", layernorm(sd, _k(prefix, "norm1"))),
      **nest("ln2", layernorm(sd, _k(prefix, "norm2"))),
      **nest("ln3", layernorm(sd, _k(prefix, "norm3"))),
      **nest("ff1", linear(sd, _k(prefix, "linear1"))),
      **nest("ff2", linear(sd, _k(prefix, "linear2"))),
  }


def convert_transformer_decoder(sd, prefix, n_layers, queries_key=None):
  """torch nn.TransformerDecoder (+ final norm) ->
  heads.TransformerDecoderJoin. queries_key: the state-dict key of the
  learned queries (e.g. 'checkpoint_query')."""
  out = nest("ln_f", layernorm(sd, _k(prefix, "norm")))
  for i in range(n_layers):
    out.update(nest(f"layer{i}", convert_transformer_decoder_layer(
        sd, _k(prefix, f"layers.{i}"))))
  if queries_key is not None:
    out["queries"] = t2t(sd[queries_key])
  return out


def convert_bert_encoder(sd, prefix, n_layers):
  """HuggingFace BertModel -> models.bert.BertEncoder. prefix: the
  BertModel's place in the state dict ('model' in the reference PlanT)."""
  out = {
      "position_embeddings": t2t(
          sd[_k(prefix, "embeddings.position_embeddings.weight")]),
      "token_type_embeddings": t2t(
          sd[_k(prefix, "embeddings.token_type_embeddings.weight")]),
      **nest("emb_ln", layernorm(sd, _k(prefix, "embeddings.LayerNorm"))),
  }
  for i in range(n_layers):
    lp = _k(prefix, f"encoder.layer.{i}")
    out.update(nest(f"layer{i}", {
        **nest("attn", mha_separate(
            sd, f"{lp}.attention.self.query", f"{lp}.attention.self.key",
            f"{lp}.attention.self.value", f"{lp}.attention.output.dense")),
        **nest("attn_ln", layernorm(sd, f"{lp}.attention.output.LayerNorm")),
        **nest("intermediate", linear(sd, f"{lp}.intermediate.dense")),
        **nest("output", linear(sd, f"{lp}.output.dense")),
        **nest("output_ln", layernorm(sd, f"{lp}.output.LayerNorm")),
    }))
  return out


def convert_plant(sd, n_layers=8, num_types=6, num_attributes=7):
  """reference plant.PlanT state dict -> models.plant.PlanT: the BERT
  encoder, token and type embeddings, forecast heads, the waypoint GRU,
  the velocity branch, the target-speed MLP and the checkpoint decoder."""
  out = {
      **nest("bert", convert_bert_encoder(sd, "model", n_layers)),
      "cls_emb": t2t(sd["cls_emb"]),
      **nest("tok_emb", linear(sd, "tok_emb")),
      **nest("wp_head", linear(sd, "wp_head")),
      **nest("wp_gru", gru_cell(sd, "wp_decoder")),
      **nest("wp_output", linear(sd, "wp_output")),
      **nest("target_speed_fc1", linear(sd, "target_speed_network.0")),
      **nest("target_speed_head", linear(sd, "target_speed_network.2")),
      **nest("checkpoint_decoder", convert_gru_interfuser(
          sd, "checkpoint_decoder", target_point_size=0)),
  }
  for i in range(num_types):
    out[f"obj_token{i}"] = t2t(sd[f"obj_token.{i}"])
    out.update(nest(f"obj_emb{i}", linear(sd, f"obj_emb.{i}")))
  for i in range(num_attributes):
    out.update(nest(f"forecast_head{i}", linear(sd, f"heads.{i}")))
  if "velocity_encoder.0.weight" in sd:
    out.update(nest("vel_fc1", linear(sd, "velocity_encoder.0")))
    out.update(nest("vel_fc2", linear(sd, "velocity_encoder.2")))
    out.update(nest("velocity_norm", batchnorm_scale_bias(
        sd, "velocity_normalization")))
  return out


def convert_perspective_decoder(sd, prefix):
  """reference transfuser_utils.PerspectiveDecoder ->
  heads.PerspectiveDecoder (the Sequentials' conv pairs)."""
  out = {}
  for i in (1, 2, 3):
    out.update(nest(f"deconv{i}_0", conv2d(sd, _k(prefix, f"deconv{i}.0"))))
    out.update(nest(f"deconv{i}_1", conv2d(sd, _k(prefix, f"deconv{i}.2"))))
  return out
