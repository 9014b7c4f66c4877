"""Port parity: checkpoints (carla_garage_tpu_torch/utils/checkpoint.py).

Every committed ``checkpoints/*/meta.json`` rebuilds through
``config_from_meta`` into the config the JAX package builds from it, field
for field, with tuples, and hashable. Weights saved by the JAX package's
orbax ``save_checkpoint`` carry over to the port (``load_flax_params``,
then the port's own save and load) with the forward of flax's
``apply`` (the model tests' tolerances), and the port's save and load
round trip, optimizer state included, is bit-equal.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from carla_garage_tpu.models import plant as j_plant
from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.utils import checkpoint as j_ckpt
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models.plant import PlanT, PlanTConfig, micro_plant
from carla_garage_tpu_torch.models.transfuser import (LidarCenterNet,
                                                      TransfuserConfig,
                                                      micro_config)
from carla_garage_tpu_torch.structs import tree_items
from carla_garage_tpu_torch.utils.checkpoint import (config_from_meta,
                                                     load_checkpoint,
                                                     save_checkpoint)
from test_torch_port_eval import _random_params
from test_torch_port_plant import plant_inputs

ROOT = pathlib.Path(__file__).resolve().parent.parent
METAS = sorted((ROOT / "checkpoints").glob("*/meta.json"))
J_CLASSES = {"transfuser": jtf.TransfuserConfig, "plant": j_plant.PlanTConfig}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core): a torch
  thread pool of its own per process would oversubscribe the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.mark.parametrize("path", METAS, ids=[p.parent.name for p in METAS])
def test_config_from_meta_matches_the_jax_config(path):
  meta = json.loads(path.read_text())
  cfg = config_from_meta(meta)
  j_cls = J_CLASSES[meta["model"]]
  want = j_cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in meta["config"].items()})
  assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
  for f in dataclasses.fields(cfg):
    assert type(getattr(cfg, f.name)) is type(getattr(want, f.name)), f.name
  hash(cfg)
  # a config rebuilt from JSON by hand keeps the lists and is not the saved
  # one: the fault config_from_meta repairs
  if meta["config"].get("img_anchors") is not None:
    naive = type(cfg)(**meta["config"])
    assert naive != cfg and isinstance(naive.img_anchors, list)
  if path.parent.name.startswith("transfuser_full"):
    assert cfg == TransfuserConfig()
  if path.parent.name.startswith("plant"):
    assert isinstance(cfg, PlanTConfig) and cfg.hidden == 256


def test_config_from_meta_rejects_unknown_models_and_fields():
  with pytest.raises(ValueError, match="model"):
    config_from_meta({"model": "aim", "config": {}})
  with pytest.raises(ValueError, match="no fields"):
    config_from_meta({"model": "plant", "config": {"hidden": 8, "depth": 2}})


def _transfuser_case():
  c = dataclasses.replace(micro_config(), img_h=32, img_w=64, lidar_h=64,
                          lidar_w=64, img_anchors=(1, 2),
                          lidar_anchors=(2, 2))
  jc = jtf.TransfuserConfig(**dataclasses.asdict(c))
  rng = np.random.default_rng(0)
  x = [rng.uniform(0, 1, (2, c.img_h, c.img_w, 3)).astype(np.float32),
       rng.uniform(0, 1, (2, c.lidar_h, c.lidar_w, 2)).astype(np.float32),
       rng.normal(size=(2, 2)).astype(np.float32) * 10,
       np.eye(6, dtype=np.float32)[[1, 3]],
       rng.uniform(0, 8, (2,)).astype(np.float32)]
  return "transfuser", c, jtf.LidarCenterNet(jc), LidarCenterNet, x


def _plant_case():
  c = micro_plant()
  x = [np.asarray(a) for a in plant_inputs(c, 2, 0)]
  return "plant", c, j_plant.PlanT(c), PlanT, x


@pytest.mark.parametrize("case", [_transfuser_case, _plant_case],
                         ids=["transfuser", "plant"])
def test_orbax_weights_carry_over_to_the_port(case, tmp_path):
  """JAX writes with orbax and reads back; the port loads the tree, saves
  its own checkpoint and loads that into a fresh model, whose forward is
  flax's: max |diff| within 1e-4 of an output's scale (the micro models'
  tolerance in tests/test_torch_port_model.py and test_torch_port_plant.py,
  float32 convolutions and attention of two libraries)."""
  name, c, jm, cls, x = case()
  params = _random_params(jax.eval_shape(jm.init, jax.random.key(0), *x),
                          seed=5)
  meta = {"model": name, "config": dataclasses.asdict(c), "step": 7}
  j_ckpt.save_checkpoint(str(tmp_path / "jax"), params, meta=meta)
  j_params, j_meta = j_ckpt.load_checkpoint(
      str(tmp_path / "jax"), jax.tree.map(np.zeros_like, params))
  assert j_meta == json.loads(json.dumps(meta))
  want = jax.jit(jm.apply)(j_params, *x)

  cfg = config_from_meta(j_meta)
  assert cfg == c
  first = load_flax_params(cls(cfg), jax.tree.map(np.asarray, j_params))
  save_checkpoint(str(tmp_path / "port"), first, meta=j_meta)
  torch.manual_seed(123)
  fresh = cls(cfg)
  sd, meta_back = load_checkpoint(str(tmp_path / "port"), fresh)
  assert meta_back == j_meta and all(v.device.type == "cpu"
                                   for v in sd.values())
  with torch.no_grad():
    got = fresh(*[torch.from_numpy(a) for a in x])
  want_leaves = dict(tree_items(jax.tree.map(
      lambda a: torch.from_numpy(np.asarray(a, np.float32)), want)))
  got_leaves = dict(tree_items(got))
  assert set(got_leaves) == set(want_leaves) and got_leaves
  for k, w in want_leaves.items():
    scale = max(float(w.abs().max()), 1.0)
    err = float((got_leaves[k].float() - w).abs().max())
    assert err <= 1e-4 * scale, (k, err, scale)


def test_round_trip_with_the_optimizer_is_bit_equal(tmp_path):
  torch.manual_seed(0)
  model = PlanT(micro_plant())
  opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
  x = [torch.from_numpy(np.asarray(a)) for a in
       plant_inputs(micro_plant(), 2, 1)]

  def step(m, o):
    o.zero_grad()
    out = m(*x)
    (out["pred_wp"].square().mean() +
     out["pred_target_speed"].square().mean()).backward()
    o.step()

  for _ in range(2):
    step(model, opt)
  save_checkpoint(str(tmp_path / "c"), model, meta={"model": "plant"},
                  optimizer=opt)
  # the snapshot does not follow later training of the live model
  step(model, opt)
  torch.manual_seed(1)
  fresh = PlanT(micro_plant())
  fresh_opt = torch.optim.AdamW(fresh.parameters(), lr=1e-3,
                                weight_decay=0.01)
  load_checkpoint(str(tmp_path / "c"), fresh, optimizer=fresh_opt)
  step(fresh, fresh_opt)
  for (n, a), (_, b) in zip(model.state_dict().items(),
                            fresh.state_dict().items()):
    assert torch.equal(a, b), n
  sa, sb = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
  assert sa.keys() == sb.keys()
  for k in sa:
    for f in ("exp_avg", "exp_avg_sq", "step"):
      assert torch.equal(sa[k][f], sb[k][f]), (k, f)
  _, meta = load_checkpoint(str(tmp_path / "c"), meta_only=True)
  assert meta == {"model": "plant"}
  save_checkpoint(str(tmp_path / "d"), model)
  with pytest.raises(KeyError, match="optimizer"):
    load_checkpoint(str(tmp_path / "d"), optimizer=fresh_opt)
