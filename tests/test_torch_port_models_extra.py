"""Port parity: the remaining models, torch vs flax on the CPU.

  * ``grid_sample_2d`` on in-range and out-of-range points, one map and a
    batch of maps: the same f32 arithmetic, 1e-6;
  * ``RegNetY`` with GroupNorm and with the folded BatchNorm
    (norm="bn_affine"), ``AIMBackbone``, ``BevEncoder`` on a small grid,
    ``VideoResNet`` (even and odd sizes, so SAME pads both ways),
    ``SwinTransformer3D`` (a shifted block, windows clipped to the input)
    and ``GRUWaypointsPredictorTransFuser`` (learn_origin on and off, no
    target point): the same seeded weights from ``load_flax_params``, the
    same inputs, every output within the TransFuser model test's bar
    (1e-4 of max(1, the output's scale), float32);
  * the BEV encoder's top-down map sits at stride 8 of the camera, and the
    projection's pixel coordinates are divided by 4 all the same: most
    frustum samples clamp to the map's border, in JAX and in the port.
Weights are drawn in numpy for the shapes ``jax.eval_shape`` gives; torch
runs on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.models import aim as j_aim
from carla_garage_tpu.models import backbones as j_bb
from carla_garage_tpu.models import bev_encoder as j_bev
from carla_garage_tpu.models import heads as j_heads
from carla_garage_tpu.models import video_nets as j_vid
from carla_garage_tpu.ops.sampling import grid_sample_2d as j_grid_sample
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import aim, backbones, bev_encoder, heads
from carla_garage_tpu_torch.models import video_nets
from carla_garage_tpu_torch.ops.sampling import grid_sample_2d
from test_torch_port_model import ATOL_MODEL

T = lambda a: torch.from_numpy(np.array(a))
MICRO = j_bb.REGNETY_MICRO


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def seeded_params(module, *args, seed=0):
  """Weights for `module`'s flax tree, drawn in numpy: kernels ~ N(0,
  1/fan_in), scales near 1 (GroupNorm, LayerNorm and the folded BatchNorm
  alike), biases, embeddings and position biases small."""
  shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
  rng = np.random.default_rng(seed)

  def leaf(path, s):
    name = path[-1].key
    x = rng.normal(0.0, 1.0, s.shape)
    if name == "kernel":
      x = x / np.sqrt(max(np.prod(s.shape[:-1]), 1))
    elif name == "scale":
      x = 1.0 + 0.05 * x
    else:
      x = 0.02 * x
    return np.asarray(x, np.float32)

  return jax.tree_util.tree_map_with_path(leaf, shapes)


def port(module, params):
  return load_flax_params(module, params).eval()


def close(got, want, what):
  """The model test's bar: 1e-4 of max(1, the output's scale)."""
  want = np.asarray(want)
  got = got.detach().numpy()
  assert got.shape == want.shape, (what, got.shape, want.shape)
  err = float(np.max(np.abs(got - want)))
  assert err < ATOL_MODEL * max(1.0, float(np.max(np.abs(want)))), \
      (what, err)


def nchw(x):
  return T(np.moveaxis(x, -1, 1))


def nhwc(t):
  return t.permute(0, 2, 3, 1)


# --- grid_sample_2d ---------------------------------------------------------

@pytest.mark.parametrize("case", ["inside", "outside", "batched"])
def test_grid_sample_2d_matches_jax(case):
  rng = np.random.default_rng(0)
  H, W, C = 7, 11, 5
  img = rng.normal(size=(H, W, C)).astype(np.float32)
  if case == "inside":
    coords = rng.uniform(0, [W - 1, H - 1], (4, 9, 2))
  else:
    # far past every border, on the last row / column, exact integers
    coords = rng.uniform(-20, 30, (6, 13, 2))
    coords[0, :4] = [[W - 1, H - 1], [0, 0], [W - 1.0, 2.5], [3.0, H - 1]]
    coords[1, :3] = [[W + 0.25, 1.5], [-0.75, H + 3], [5.0, 4.0]]
  coords = coords.astype(np.float32)
  if case == "batched":
    imgs = rng.normal(size=(3, H, W, C)).astype(np.float32)
    want = jax.vmap(lambda im: j_grid_sample(im, coords))(imgs)
    got = grid_sample_2d(T(imgs), T(coords))
  else:
    want = j_grid_sample(img, coords)
    got = grid_sample_2d(T(img), T(coords))
  assert got.shape == want.shape
  # the same clamps, corners and weights in float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)
  if case == "outside":
    # a point past the border takes the border's value exactly
    np.testing.assert_array_equal(got[0, 0].numpy(), img[H - 1, W - 1])
    np.testing.assert_array_equal(got[0, 1].numpy(), img[0, 0])


# --- RegNetY and AIM --------------------------------------------------------

@pytest.mark.parametrize("norm", ["gn", "bn_affine"])
def test_regnety_matches_flax(norm):
  x = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 3)).astype(
      np.float32)
  jm = j_bb.RegNetY(**MICRO, norm=norm)
  params = seeded_params(jm, x, seed=2)
  want = jax.jit(jm.apply)(params, x)
  tm = port(backbones.make_encoder("regnety_micro", norm=norm), params)
  with torch.no_grad():
    got = tm(nchw(x))
  assert len(got) == 4
  for i, (g, w) in enumerate(zip(got, want)):
    # strides 4, 8, 16, 32
    assert g.shape[-2:] == (64 // 2 ** (i + 2), 96 // 2 ** (i + 2))
    close(nhwc(g), w, f"stage {i}")
  if norm == "bn_affine":
    assert isinstance(tm.stem.norm, backbones.ChannelAffineNorm)


def test_aim_matches_flax():
  x = np.random.default_rng(3).uniform(0, 1, (2, 64, 128, 3)).astype(
      np.float32)
  jm = j_aim.AIMBackbone(arch="regnety_micro", out_features=32)
  params = seeded_params(jm, x, seed=4)
  w_map, w_vec = jax.jit(jm.apply)(params, x)
  tm = port(aim.AIMBackbone("regnety_micro", out_features=32), params)
  with torch.no_grad():
    g_map, g_vec = tm(nchw(x))
  close(nhwc(g_map), w_map, "last stage")
  close(g_vec, w_vec, "projection")


# --- the BEV encoder --------------------------------------------------------

GRID = dict(bev_h=16, bev_w=16, n_height=4, img_h=64, img_w=128)


def _bev_models(seed):
  proj = j_bev.make_projection_grid(**GRID)
  rng = np.random.default_rng(seed)
  rgb = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
  lidar = rng.uniform(0, 1, (2, 16, 16, 2)).astype(np.float32)
  jm = j_bev.BevEncoder(arch="regnety_micro", image_features=32,
                        bev_latent=8, bev_out=16, projection=proj)
  params = seeded_params(jm, rgb, lidar, seed=seed + 1)
  tm = port(bev_encoder.BevEncoder(
      "regnety_micro", image_features=32, bev_latent=8, bev_out=16,
      projection=bev_encoder.make_projection_grid(**GRID),
      lidar_channels=2), params)
  return proj, rgb, lidar, jm, params, tm


def test_projection_grid_matches_jax():
  for kw in (GRID, {}):
    want = j_bev.make_projection_grid(**kw)
    got = bev_encoder.make_projection_grid(**kw)
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.valid, want.valid)


def test_bev_encoder_matches_flax():
  _, rgb, lidar, jm, params, tm = _bev_models(5)
  want = jax.jit(jm.apply)(params, rgb, lidar)
  with torch.no_grad():
    got = tm(nchw(rgb), nchw(lidar))
  assert got.shape == (2, 16, 4, 4)
  close(nhwc(got), want, "bev features")


def test_bev_encoder_samples_a_stride_8_map_at_quarter_coordinates():
  """The JAX module's top-down path ends at feats[1], at stride 8, while
  it divides the projection's pixel coordinates by 4. The port keeps that
  arithmetic: its camera BEV is the stride-8 map sampled at coords / 4,
  and most frustum samples clamp to the map's border."""
  proj, rgb, _, _, params, tm = _bev_models(7)
  m = j_bb.RegNetY(**MICRO)
  feats = jax.eval_shape(
      lambda r: m.init_with_output(jax.random.key(0), r)[0], rgb)
  assert feats[1].shape[1:3] == (64 // 8, 128 // 8)
  with torch.no_grad():
    fmap = tm.image_features(nchw(rgb))
    cam = tm.camera_bev(nchw(rgb))
  assert fmap.shape[-2:] == (8, 16)
  coords, valid = tm.sample_grid("cpu")
  np.testing.assert_array_equal(coords.numpy(),
                                proj.coords.reshape(-1, 2) / 4.0)
  D, Hb, Wb = proj.valid.shape
  by_hand = grid_sample_2d(nhwc(fmap), T(proj.coords / 4.0))
  by_hand = (by_hand * T(proj.valid)[None, ..., None]).mean(1)
  np.testing.assert_allclose(nhwc(cam).numpy(), by_hand.numpy(), rtol=1e-6,
                             atol=1e-6)
  # the frustum's samples past the 8x16 map, clamped to its right or
  # bottom border: 77 % of them (54 % past the right, 50 % past the bottom)
  u, v = proj.coords[..., 0] / 4.0, proj.coords[..., 1] / 4.0
  inside = proj.valid > 0
  assert ((u > 15) | (v > 7))[inside].mean() == 0.77
  # at the defaults (a 256x1024 camera, a 32x128 map): 75 %, half of them
  # past the right border and half past the bottom one
  d = j_bev.make_projection_grid()
  u, v, inside = d.coords[..., 0] / 4.0, d.coords[..., 1] / 4.0, d.valid > 0
  assert ((u > 127) | (v > 31))[inside].mean() == 0.75
  assert (u > 127)[inside].mean() == 0.5 and (v > 31)[inside].mean() == 0.5


# --- the temporal LiDAR encoders --------------------------------------------

def _ncthw(x):
  return T(np.moveaxis(x, -1, 1))


@pytest.mark.parametrize("shape", [(2, 3, 64, 64, 2), (1, 2, 30, 22, 2)])
def test_video_resnet_matches_flax(shape):
  x = np.random.default_rng(8).uniform(0, 1, shape).astype(np.float32)
  jm = j_vid.VideoResNet(widths=(8, 16, 32, 64))
  params = seeded_params(jm, x, seed=9)
  want = jax.jit(jm.apply)(params, x)
  tm = port(video_nets.VideoResNet((8, 16, 32, 64),
                                   in_channels=shape[-1]), params)
  with torch.no_grad():
    got = tm(_ncthw(x))
  assert len(got) == 4
  if shape[2] == 64:
    assert got[0].shape == (2, 8, 32, 32) and got[-1].shape == (2, 64, 4, 4)
  for i, (g, w) in enumerate(zip(got, want)):
    close(nhwc(g), w, f"stage {i}")


SWIN_CASES = {
    # depth 2 in the first stage: a shifted block; the last stages' 2x2
    # and 1x1 maps clip the (2,4,4) window
    "shifted": dict(x=(1, 2, 64, 64, 2), embed_dim=16, depths=(2, 1, 1, 1),
                    n_heads=(2, 2, 2, 2), window=(2, 4, 4)),
    # an 8x16 first-stage map and one frame under a (2,16,16) window:
    # every stage's window is clipped, the shifted block's to (1,4,8)
    "clipped": dict(x=(2, 1, 32, 64, 3), embed_dim=8, depths=(1, 2, 1, 1),
                    n_heads=(2, 2, 4, 4), window=(2, 16, 16)),
}


@pytest.mark.parametrize("case", list(SWIN_CASES))
def test_swin3d_matches_flax(case):
  spec = dict(SWIN_CASES[case])
  shape = spec.pop("x")
  x = np.random.default_rng(10).uniform(0, 1, shape).astype(np.float32)
  jm = j_vid.SwinTransformer3D(**spec)
  params = seeded_params(jm, x, seed=11)
  want = jax.jit(jm.apply)(params, x)
  tm = port(video_nets.SwinTransformer3D(
      **spec, in_channels=shape[-1], input_size=shape[1:4]), params)
  blocks = [m for m in tm.modules()
            if isinstance(m, video_nets.SwinBlock3D)]
  assert any(b.shift for b in blocks)
  assert any(b.ws != spec["window"] for b in blocks)
  with torch.no_grad():
    got = tm(_ncthw(x))
  assert len(got) == 4
  for i, (g, w) in enumerate(zip(got, want)):
    close(nhwc(g), w, f"stage {i}")


# --- the TransFuser GRU head ------------------------------------------------

@pytest.mark.parametrize("learn_origin,tp_size", [(True, 2), (False, 2),
                                                  (False, 0)])
def test_gru_transfuser_head_matches_flax(learn_origin, tp_size):
  rng = np.random.default_rng(12)
  hidden = 16
  z = rng.normal(size=(3, hidden + 2 * learn_origin)).astype(np.float32)
  tp = rng.normal(0, 10, (3, 2)).astype(np.float32)
  jm = j_heads.GRUWaypointsPredictorTransFuser(
      pred_len=8, hidden_size=hidden, target_point_size=tp_size,
      learn_origin=learn_origin)
  params = seeded_params(jm, z, tp, seed=13)
  want = jax.jit(jm.apply)(params, z, tp)
  tm = port(heads.GRUWaypointsPredictorTransFuser(
      8, hidden, target_point_size=tp_size, learn_origin=learn_origin),
      params)
  with torch.no_grad():
    got = tm(T(z), T(tp))
  assert got.shape == (3, 8, 2)
  close(got, want, "waypoints")
  if tp_size == 0:
    with torch.no_grad():
      assert torch.equal(got, tm(T(z), T(tp + 5.0)))
