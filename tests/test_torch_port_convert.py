"""Port parity: the reference-checkpoint converters, torch vs JAX on the CPU.

Reference-layout state dicts are synthesized by ``tests/port_inputs.py``:
the timm RegNetY key layout comes from a stand-in of timm's RegNet
(copied from ``tests/test_assemble.py``), every other key follows the
reference's module names (TransfuserBackbone, LidarCenterNet, HuggingFace
BERT, PlanT). All values are drawn from a numpy seed, BatchNorm running
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
from port_inputs import (REGNETY_032, RefDict, plant_reference_sd,
                         transfuser_reference_sd)
from test_torch_port_model import _compare, _inputs
from test_torch_port_plant import close, plant_inputs
from test_torch_port_scene import jax_batch_to_port
from test_torch_port_tick import _draws, _leaf

B = 2
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


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
