"""PlanT, the object-level transformer planner (port of
carla_garage_tpu/models/plant.py).

  * tokens: [CLS] + object boxes (7 attributes: x, y, extent_x, extent_y,
    yaw, speed, brake) + route points as pseudo-boxes ([x, y, 0, ...]);
  * embedding: tok_emb(attributes) + a per-type bias
    obj_emb{i}(obj_token{i}) picked by each token's type;
  * encoder: BERT (models/bert.py), no attention mask;
  * forecast: 7 per-attribute classification heads over the object tokens;
  * waypoints: wp_head on [CLS ; velocity branch] gives the GRU's hidden
    state and a learned origin; each step's input is [x, light, stop,
    junction];
  * target speed: a two-layer MLP on [CLS ; velocity ; flags];
  * checkpoints: the InterFuser GRU over the route tokens, no target-point
    hidden state.

Module and parameter names are the flax tree's, so
``convert.load_flax_params`` loads a JAX PlanT as it is.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from portbench.reference.cgt.models.backbones import AffineNorm
from portbench.reference.cgt.models.bert import BertEncoder
from portbench.reference.cgt.models.heads import (
    GRUCell, GRUWaypointsPredictorInterFuser)
from portbench.reference.cgt.models.layers import Linear


class ObjType:
  """Token type codes."""
  VEHICLE = 0
  WALKER = 1
  LIGHT = 2
  STOP = 3
  ROUTE = 4
  OTHER = 5    # CLS


@dataclasses.dataclass(frozen=True)
class PlanTConfig:
  hidden: int = 512          # bert-medium
  n_layers: int = 8
  n_heads: int = 8
  intermediate: int = 2048
  max_positions: int = 512   # BERT position-embedding table size
  num_attributes: int = 7
  num_types: int = 6
  max_objects: int = 30      # vehicle/walker/light/stop token slots
  num_route_points: int = 20 # route tokens = predicted checkpoints
  pred_len: int = 8
  target_speed_bins: int = 4
  gru_hidden: int = 64
  use_velocity: bool = True
  learn_origin: bool = True
  # quantization precisions per attribute (x, y, ex, ey, yaw, speed, brake)
  precision_pos: int = 7
  precision_angle: int = 4
  precision_speed: int = 5
  precision_brake: int = 2
  forecast_time: float = 0.5

  @property
  def vocab_sizes(self):
    p = (self.precision_pos,) * 4 + (self.precision_angle,
                                     self.precision_speed,
                                     self.precision_brake)
    return tuple(2 ** x for x in p)

  @property
  def max_tokens(self):
    return 1 + self.max_objects + self.num_route_points


def micro_plant() -> PlanTConfig:
  return PlanTConfig(hidden=64, n_layers=2, n_heads=2, intermediate=256,
                     max_positions=64, max_objects=10, num_route_points=6)


WP_HIDDEN = 64          # the waypoint GRU's width (plant.py:276-301)
N_FLAGS = 3             # light, stop, junction


class PlanT(nn.Module):

  def __init__(self, cfg: PlanTConfig):
    super().__init__()
    c = self.cfg = cfg
    A = c.num_attributes
    self.cls_emb = nn.Parameter(torch.randn(1, A + 1))
    for i in range(c.num_types):
      setattr(self, f"obj_token{i}", nn.Parameter(torch.randn(1, A)))
      self.add_module(f"obj_emb{i}", Linear(A, c.hidden))
    self.tok_emb = Linear(A, c.hidden)
    self.bert = BertEncoder(c.hidden, c.n_layers, c.n_heads, c.intermediate,
                            c.max_positions)
    for i, v in enumerate(c.vocab_sizes):
      self.add_module(f"forecast_head{i}", Linear(c.hidden, v))
    width = c.hidden
    if c.use_velocity:
      self.velocity_norm = AffineNorm(1)
      self.vel_fc1 = Linear(1, 128)
      self.vel_fc2 = Linear(128, 128)
      width += 128
    self.wp_head = Linear(width, WP_HIDDEN + (2 if c.learn_origin else 0))
    self.wp_gru = GRUCell(2 + N_FLAGS, WP_HIDDEN)
    self.wp_output = Linear(WP_HIDDEN, 2)
    self.target_speed_fc1 = Linear(width + N_FLAGS, 128)
    self.target_speed_head = Linear(128, c.target_speed_bins)
    self.checkpoint_decoder = GRUWaypointsPredictorInterFuser(
        c.hidden, c.num_route_points, c.gru_hidden, target_point_size=0)

  def forward(self, boxes, box_types, route, light_hazard, stop_hazard,
              junction, velocity):
    """boxes [B,O,7] ego-frame attributes (padded rows zero), box_types
    [B,O] int (ObjType), route [B,R,2] ego-frame route points,
    light/stop/junction [B] flags, velocity [B] m/s.

    Returns dict: pred_wp [B,pred_len,2], pred_target_speed [B,bins],
    pred_checkpoint [B,R,2], pred_forecast tuple of 7 per-attribute logits
    [B,O,vocab_i]."""
    c = self.cfg
    B, O, A = boxes.shape
    R = route.shape[1]
    dev = boxes.device

    route_attrs = torch.cat([route, route.new_zeros((B, R, A - 2))], -1)
    cls_attrs = self.cls_emb[None, :, :A].expand(B, 1, A)
    attrs = torch.cat([cls_attrs, boxes, route_attrs], 1)
    types = torch.cat([
        torch.full((B, 1), ObjType.OTHER, dtype=torch.long, device=dev),
        box_types.long(),
        torch.full((B, R), ObjType.ROUTE, dtype=torch.long, device=dev)], 1)
    emb = self.tok_emb(attrs)
    type_bias = torch.stack([
        getattr(self, f"obj_emb{i}")(getattr(self, f"obj_token{i}"))[0]
        for i in range(c.num_types)])                   # [types, hidden]
    x = self.bert(emb + type_bias[types])
    cls_f = x[:, 0]
    obj_f = x[:, 1:1 + O]
    route_f = x[:, 1 + O:1 + O + R]

    out = {"pred_forecast": tuple(
        getattr(self, f"forecast_head{i}")(obj_f)
        for i in range(len(c.vocab_sizes)))}
    if c.use_velocity:
      vn = self.velocity_norm(velocity[:, None])
      ve = torch.relu(self.vel_fc2(torch.relu(self.vel_fc1(vn))))
      cls_f = torch.cat([cls_f, ve], -1)
    flags = torch.stack([light_hazard, stop_hazard, junction],
                        -1).to(torch.float32)           # [B,3]

    z = self.wp_head(cls_f)
    if c.learn_origin:
      xw, z = z[:, WP_HIDDEN:WP_HIDDEN + 2], z[:, :WP_HIDDEN]
    else:
      xw = z.new_zeros((B, 2))
    wps = []
    for _ in range(c.pred_len):
      z = self.wp_gru(z, torch.cat([xw, flags], -1))
      xw = xw + self.wp_output(z)
      wps.append(xw)
    out["pred_wp"] = torch.stack(wps, 1)

    h = torch.relu(self.target_speed_fc1(torch.cat([cls_f, flags], -1)))
    out["pred_target_speed"] = self.target_speed_head(h)
    out["pred_checkpoint"] = self.checkpoint_decoder(route_f)
    return out
