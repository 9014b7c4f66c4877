"""Port parity: TransFuser++ (LidarCenterNet) and its layers, torch vs flax.

Random flax params go through ``load_flax_params`` into the port; the same
seeded numpy inputs go through both, in float32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_garage_tpu.models import transfuser as jtf
from carla_garage_tpu.models.heads import \
    sine_position_embedding as j_sine
from carla_garage_tpu.ops.norm import TpuGroupNorm as JGroupNorm
from carla_garage_tpu_torch.convert import load_flax_params
from carla_garage_tpu_torch.models import transfuser as ttf
from carla_garage_tpu_torch.models.fusion import upsample_bilinear
from carla_garage_tpu_torch.models.heads import sine_position_embedding
from carla_garage_tpu_torch.ops.norm import TpuGroupNorm

# docs/PARITY.md's bar for whole-model activation parity in f32, max |diff|
# < 1e-4, taken relative to an output's scale where that exceeds 1: the
# checkpoints reach ~60 m, where 1e-4 is 26 f32 ulps of the GRU's 10-step
# cumulative sum (measured: 1.4e-4 absolute, 2.3e-6 of the scale)
ATOL_MODEL = 1e-4


def _np_tree(params):
  return jax.tree.map(np.asarray, params)


def _to_torch(out):
  if isinstance(out, dict):
    return {k: _to_torch(v) for k, v in out.items()}
  return np.asarray(out)


def _inputs(c, B, seed):
  rng = np.random.default_rng(seed)
  return dict(
      rgb=rng.uniform(0, 1, (B, c.img_h, c.img_w, 3)).astype(np.float32),
      lidar=(rng.integers(0, 6, (B, c.lidar_h, c.lidar_w, 2)) / 5.0
             ).astype(np.float32),
      tp=rng.normal(0, 10, (B, 2)).astype(np.float32),
      cmd=np.eye(6, dtype=np.float32)[rng.integers(0, 6, B)],
      vel=rng.uniform(0, 8, (B,)).astype(np.float32))


def _compare(j_out, t_out, path=""):
  if isinstance(j_out, dict):
    assert set(j_out) == set(t_out), path
    for k in j_out:
      _compare(j_out[k], t_out[k], f"{path}/{k}")
    return
  j = np.asarray(j_out)
  t = t_out.detach().numpy()
  assert j.shape == t.shape, (path, j.shape, t.shape)
  err = float(np.max(np.abs(j - t)))
  assert err < ATOL_MODEL * max(1.0, float(np.max(np.abs(j)))), (path, err)


@pytest.mark.parametrize("variant", ["micro", "micro_wide_cam"])
def test_lidar_center_net_matches_flax(variant):
  c = jtf.micro_config()
  if variant == "micro_wide_cam":
    # the sensor tick's test shape: 32x128 camera, 256x256 LiDAR grid
    c = dataclasses.replace(c, img_h=32, img_w=128, lidar_h=256,
                            lidar_w=256, img_anchors=(1, 4),
                            lidar_anchors=(8, 8))
  B = 2
  x = _inputs(c, B, seed=1)
  jm = jtf.LidarCenterNet(c)
  # flax's init runs op by op for a minute unless jitted
  params = jax.jit(jm.init)(jax.random.key(3), x["rgb"], x["lidar"], x["tp"],
                            x["cmd"], x["vel"])
  # perturb the zero/one inits so every parameter carries information
  leaves, treedef = jax.tree.flatten(params)
  r = np.random.default_rng(5)
  leaves = [np.asarray(v) + r.normal(0, 0.02, v.shape).astype(np.float32)
            for v in leaves]
  params = jax.tree.unflatten(treedef, leaves)
  j_out = jax.jit(jm.apply)(params, x["rgb"], x["lidar"], x["tp"], x["cmd"],
                            x["vel"])

  tc = ttf.TransfuserConfig(**dataclasses.asdict(c))
  tm = load_flax_params(ttf.LidarCenterNet(tc), _np_tree(params)).eval()
  with torch.no_grad():
    t_out = tm(*(torch.from_numpy(x[k]) for k in
                 ("rgb", "lidar", "tp", "cmd", "vel")))
  _compare(_to_torch(j_out), t_out)


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 72), 24),
                                          ((1, 4, 4, 216), 27),
                                          ((2, 3, 3, 1512), 28)])
def test_group_norm_matches_flax(shape, groups):
  rng = np.random.default_rng(0)
  x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
  jm = JGroupNorm(num_groups=groups)
  p = jm.init(jax.random.key(0), x)
  p = jax.tree.map(lambda v: v + rng.normal(0, 0.1, v.shape).astype(
      np.float32), p)
  want = np.asarray(jm.apply(p, x))
  tm = TpuGroupNorm(groups, shape[-1])
  with torch.no_grad():
    tm.scale.copy_(torch.tensor(np.asarray(p["params"]["scale"])))
    tm.bias.copy_(torch.tensor(np.asarray(p["params"]["bias"])))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  # f32 moments summed in another order: a few ulps of the normalized value
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((1, 1), (8, 8)), ((8, 32), (64, 256)),
                                     ((2, 3), (5, 7)), ((4, 4), (4, 4))])
def test_bilinear_upsample_matches_jax_resize(src, dst):
  rng = np.random.default_rng(1)
  x = rng.normal(size=(2,) + src + (3,)).astype(np.float32)
  want = np.asarray(jax.image.resize(x, (2,) + dst + (3,),
                                     method="bilinear"))
  got = upsample_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
  # the same two-tap half-pixel weights; f32 rounding of the weights only
  np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                             rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w,ch", [(8, 8, 256), (2, 2, 64), (1, 4, 36)])
def test_sine_position_embedding_matches_jax(h, w, ch):
  want = np.asarray(j_sine(h, w, ch))
  got = sine_position_embedding(h, w, ch).numpy()
  # sin/cos of the same f32 arguments in two libraries
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
