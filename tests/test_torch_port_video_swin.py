"""The published Video Swin and TransFuser++ with it as its LiDAR branch,
held against the plain reference ``portbench/reference/vswin.py`` on the
CPU at small sizes, with seeded random weights (float32, one torch
thread):

  * the published block where the padding, the shifted windows' region
    mask and the window's clipping each fire, and where they fire
    together: the same outputs within 1e-5 of their scale (the program's
    ``scaled_dot_product_attention`` against the reference's matmuls);
  * the region mask: a token attends to another of its shifted window
    exactly where the cyclic roll did not wrap between them, so a change
    to one token reaches no token of another region;
  * the whole TransFuser++ forward with the video branch, every output;
  * the LiDAR input's channel pairs (newest first) as frames [B, 2, K, H,
    W], oldest first, and a clear refusal of a buffer of another length;
  * the buffer's length from the model's config (``lidar_history``), and
    the video config rebuilt from a checkpoint's meta;
  * the older sweeps voxelized in one call over the merged B(K-1) axis,
    bit-equal to one call a sweep.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.agents.sensor_agent import voxelize_older
from carla_garage_tpu_torch.config import DEFAULT_CONFIG
from carla_garage_tpu_torch.models import transfuser as tf
from carla_garage_tpu_torch.models import video_nets
from carla_garage_tpu_torch.sensors.voxelize import voxelize
from carla_garage_tpu_torch.utils.checkpoint import config_from_meta
from portbench.reference import vswin
from portbench.reference.cgt.models.transfuser import \
    TransfuserConfig as FrozenTransfuserConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """These tests run beside other test processes (one per core)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def seeded(model: torch.nn.Module, seed: int) -> dict:
  """A state dict for `model` drawn from `seed`: matrices ~ U scaled to
  variance 1/fan-in, norms' gains near 1, biases and the bias tables
  small but not zero."""
  g = torch.Generator().manual_seed(seed)
  sd = {}
  for name, p in model.state_dict().items():
    u = torch.rand(p.shape, generator=g) * 2 - 1
    if p.ndim >= 2 and not name.endswith("rel_bias"):
      u = u * (3.0 / np.prod(p.shape[1:])) ** 0.5
    elif name.endswith("weight") and p.ndim == 1:
      u = 1 + 0.1 * u
    else:
      u = 0.5 * u
    sd[name] = u
  return sd


def close(got, want, what, rtol=1e-5):
  scale = max(1.0, float(want.abs().max()))
  err = float((got - want).abs().max())
  assert err <= rtol * scale, (what, err, scale)


# --- the published block ----------------------------------------------------

BLOCKS = {
    # 9x11 tokens under a 4x4 window: H and W pad to 12, unshifted
    "padding": dict(size=(4, 9, 11), window=(2, 4, 4), shift=False),
    # whole windows, shifted by (1, 2, 2): the region mask alone
    "mask": dict(size=(4, 8, 8), window=(2, 4, 4), shift=True),
    # 2 frames under 4 clip the window to (2, 4, 4); 4 rows fill it and 8
    # columns fill two: no padding, and no shift where clipped
    "clipping": dict(size=(2, 4, 8), window=(4, 4, 4), shift=False),
    # all three at once: 2 frames clip (4, 7, 7) and are not shifted; 9
    # rows and 10 columns shift by 3 and pad to 14
    "all": dict(size=(2, 9, 10), window=(4, 7, 7), shift=True),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_published_block_matches_the_reference(case):
  spec = BLOCKS[case]
  dim, heads = 16, 2
  block = video_nets.VideoSwinBlock(dim, heads, spec["window"],
                                    spec["size"], shift=spec["shift"])
  ref = vswin.Block(dim, heads, spec["window"], 4.0, spec["shift"])
  sd = seeded(ref, seed=3)
  block.load_state_dict(sd)
  ref.load_state_dict(sd)
  fires = {"padding": any(block.pads), "mask": block.shift,
           "clipping": block.ws != spec["window"]}
  if case == "all":
    assert all(fires.values()), fires
  else:
    assert fires[case], fires
  x = torch.randn(2, *spec["size"], dim, generator=torch.Generator()
                  .manual_seed(4))
  with torch.no_grad():
    close(block(x), ref(x), case)


@pytest.mark.parametrize("size,window", [((4, 8, 8), (2, 4, 4)),
                                         ((2, 9, 10), (4, 7, 7)),
                                         ((8, 16, 16), (8, 7, 7))])
def test_shifted_windows_mask_exactly_the_wrapped_pairs(size, window):
  """Region ids against the roll: two tokens of one shifted window share
  a region exactly where their places before the roll lie as near as
  after it on every axis; a change to one token then moves no token of
  another region."""
  ws, shift = video_nets.published_window(size, window)
  assert any(shift)
  padded = tuple(n + (-n % w) for n, w in zip(size, ws))
  regions = torch.as_tensor(video_nets.shift_regions(padded, ws, shift))
  grid = torch.stack(torch.meshgrid(*(torch.arange(n) for n in padded),
                                    indexing="ij"), -1)      # [T,H,W,3]
  src = (grid + torch.tensor(shift)) % torch.tensor(padded)  # before roll
  win = video_nets._window_partition(grid[None].float(), ws).long()
  win_src = video_nets._window_partition(src[None].float(), ws).long()
  near = ((win_src[:, :, None] - win_src[:, None, :]) ==
          (win[:, :, None] - win[:, None, :])).all(-1)
  same = regions[:, :, None] == regions[:, None, :]
  assert torch.equal(same, near)
  assert not same.all()

  dim = 8
  block = video_nets.VideoSwinBlock(dim, 2, window, size, shift=True)
  block.load_state_dict(seeded(block, seed=5))
  x = torch.randn(1, *size, dim, generator=torch.Generator().manual_seed(6))
  j = (0, 0, 0)               # rolls into the last window, region 2
  y = x.clone()
  y[(0, *j, 0)] += 1.0       # one channel: LayerNorm drops a shift of all
  with torch.no_grad():
    moved = (block(y) - block(x)).abs().amax(-1)[0]         # [T,H,W]
  # the tokens that share j's shifted window and region, by id
  rolled = tuple((a - s) % n for a, s, n in zip(j, shift, padded))
  ids = torch.full(padded, -1, dtype=torch.long)
  ids_w = video_nets._window_partition(
      torch.arange(np.prod(padded)).view(1, *padded, 1).float(), ws).long()
  flat = np.ravel_multi_index(rolled, padded)
  w_idx, t_idx = (ids_w[..., 0] == flat).nonzero()[0].tolist()
  keep = regions[w_idx] == regions[w_idx, t_idx]
  ids.view(-1)[ids_w[w_idx, :, 0]] = keep.long()
  ids = torch.roll(ids, shift, dims=(0, 1, 2))[:size[0], :size[1], :size[2]]
  assert float(moved[ids == 1].min()) > 1e-6
  assert float(moved[ids != 1].max()) < 1e-20


# --- the whole model ----------------------------------------------------------

SMALL = dict(image_arch="regnety_micro", img_h=32, img_w=64, lidar_h=64,
             lidar_w=64, n_embd=32, d_model=32, n_decoder_layers=2,
             img_anchors=(1, 2), lidar_anchors=(2, 2), lidar_channels=2,
             lidar_seq_len=4, swin_embed_dim=16, swin_depths=(2, 2, 2, 2),
             swin_heads=(2, 2, 4, 4), swin_window=(4, 7, 7))


def test_tfpp_video_swin_forward_matches_the_reference():
  c = tf.VideoTransfuserConfig(**SMALL)
  fields = {f.name for f in dataclasses.fields(FrozenTransfuserConfig)}
  ref = vswin.model(
      FrozenTransfuserConfig(**{k: v for k, v in dataclasses.asdict(c)
                                .items() if k in fields}),
      vswin.VSwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                        heads=(2, 2, 4, 4), window=(4, 7, 7), seq_len=4))
  prog = tf.LidarCenterNet(c)
  sd = seeded(ref, seed=8)
  assert set(sd) == set(prog.state_dict())
  prog.load_state_dict(sd)
  ref.load_state_dict(sd)
  prog.eval(), ref.eval()
  g = torch.Generator().manual_seed(9)
  B, K = 2, c.lidar_seq_len
  x = (torch.rand(B, c.img_h, c.img_w, 3, generator=g),
       (torch.rand(B, c.lidar_h, c.lidar_w, 2 * K, generator=g) < 0.2)
       .float() * 0.4,
       torch.randn(B, 2, generator=g) * 10, torch.eye(6)[[1, 4]],
       torch.rand(B, generator=g) * 8)
  with torch.no_grad():
    got, want = prog(*x), ref(*x)
  flat = lambda d, p="": [kv for k, v in d.items() for kv in (
      flat(v, p + k + ".") if isinstance(v, dict) else [(p + k, v)])]
  got, want = dict(flat(got)), dict(flat(want))
  assert set(got) == set(want)
  for k in want:
    close(got[k], want[k], k, rtol=1e-4)


def test_lidar_channel_pairs_become_frames_oldest_first():
  B, K, H, W = 2, 5, 3, 4
  # channel pair k holds sweep k (k = 0 the newest), slice j in 0/1
  nhwc = torch.stack([torch.full((B, H, W), 10.0 * k + j)
                      for k in range(K) for j in range(2)], -1)
  c = tf.VideoTransfuserConfig(lidar_channels=2, lidar_seq_len=K)
  frames = tf.video_frames(nhwc.permute(0, 3, 1, 2), c)
  assert frames.shape == (B, 2, K, H, W)
  for t in range(K):
    for j in range(2):
      assert torch.all(frames[:, j, t] == 10.0 * (K - 1 - t) + j)


@pytest.mark.parametrize("K", [1, 15])
def test_video_branch_refuses_a_buffer_of_another_length(K):
  c = tf.VideoTransfuserConfig(lidar_channels=2, lidar_seq_len=16)
  with pytest.raises(ValueError, match="lidar_history"):
    tf.video_frames(torch.zeros(1, 2 * K, 4, 4), c)


@pytest.mark.parametrize("config,K", [
    (tf.VideoTransfuserConfig(), 16),
    (tf.VideoTransfuserConfig(**SMALL), 4),
    (tf.TransfuserConfig(), 1),
    (tf.TransfuserConfig(lidar_channels=4), 2),
])
def test_lidar_history_follows_the_model(config, K):
  assert tf.lidar_history(config) == K


@pytest.mark.parametrize("config", [tf.VideoTransfuserConfig(**SMALL),
                                    tf.TransfuserConfig()])
def test_config_from_meta_rebuilds_the_video_config(config):
  meta = json.loads(json.dumps({"model": "transfuser",
                                "config": dataclasses.asdict(config)}))
  got = config_from_meta(meta)
  assert type(got) is type(config) and got == config


@pytest.mark.parametrize("K", [1, 2, 5])
def test_older_sweeps_voxelize_in_one_call_bit_equal(K):
  cfg = DEFAULT_CONFIG
  g = torch.Generator().manual_seed(K)
  B, N = 3, 4000
  pts = torch.empty(B, K, N, 3)
  pts[..., :2] = (torch.rand(B, K, N, 2, generator=g) - 0.5) * 80
  pts[..., 2] = torch.rand(B, K, N, generator=g) * 4 - 1
  valid = torch.rand(B, K, N, generator=g) < 0.8
  got = voxelize_older(pts, valid, cfg)
  if K == 1:
    assert got is None
    return
  want = torch.cat([voxelize(pts[:, k], valid[:, k], cfg)
                    for k in range(1, K)], 1)
  assert got.shape == (B, 2 * (K - 1), *want.shape[2:])
  assert torch.equal(got, want)
