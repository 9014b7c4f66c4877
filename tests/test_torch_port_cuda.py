"""On-card tests of the port's CUDA kernels against their plain versions.

They need an NVIDIA card with nvcc (Hopper, sm_90a) and skip elsewhere.
This file imports no JAX, so it runs on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

(--noconftest because tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from carla_garage_tpu_torch.ops.raycast import (raycast_boxes,
                                                raycast_boxes_plain)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
  # the plain version is elementwise fp32 on the card: no TF32 anywhere
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def random_box_case(B, N, K, seed):
  """Rays from one origin per episode against boxes around it, with a
  duplicated box (a tie the earlier box must win), an origin inside a box,
  and invalid boxes."""
  rng = np.random.default_rng(seed)
  origins = np.concatenate([rng.uniform(-5, 5, (B, 2)),
                            rng.uniform(0.5, 2.5, (B, 1))], -1)
  d = rng.normal(size=(B, N, 3))
  d[..., 2] = -np.abs(d[..., 2]) * 0.3
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  yaw = rng.uniform(-np.pi, np.pi, (B, K))
  boxes = np.stack([
      origins[:, :1] + rng.uniform(-30, 30, (B, K)),
      origins[:, 1:2] + rng.uniform(-30, 30, (B, K)),
      np.cos(yaw), np.sin(yaw),
      rng.uniform(0.3, 3.0, (B, K)), rng.uniform(0.3, 1.5, (B, K)),
      rng.uniform(0.5, 2.5, (B, K)),
      rng.integers(1, 9, (B, K)).astype(np.float64),
      (rng.uniform(size=(B, K)) > 0.2).astype(np.float64)], -1)
  if K >= 3:
    boxes[:, 1] = boxes[:, 0]               # exact duplicate ...
    boxes[:, 1, 7] = 5.0                    # ... of another class: a tie
    boxes[:, 0, 7] = 1.0
    boxes[:, 0, 8] = boxes[:, 1, 8] = 1.0
    boxes[0, 2, :2] = origins[0, :2]        # episode 0 starts inside box 2
    boxes[0, 2, 8] = 1.0
  f = lambda a: torch.tensor(a, dtype=torch.float32)
  return f(origins), f(d), f(boxes)


@pytest.mark.parametrize("B,N,K", [(3, 1000, 13), (2, 257, 48), (1, 5, 0)])
def test_raycast_kernel_matches_plain(cuda, B, N, K):
  o, d, bx = (x.to(cuda) for x in random_box_case(B, N, K, seed=N))
  before = raycast_boxes.launches
  t, cls = raycast_boxes(o, d, bx)
  torch.cuda.synchronize()
  assert raycast_boxes.launches == before + 1
  t_ref, cls_ref = raycast_boxes_plain(o, d, bx)
  # built with -fmad=false and IEEE division, the kernel repeats the plain
  # version's fp32 operations in its order: equal bit for bit
  assert torch.equal(t, t_ref)
  assert torch.equal(cls, cls_ref)
  if K:
    assert bool((t < 1e9).any())


def test_raycast_kernel_rejects_bad_input(cuda):
  o, d, bx = (x.to(cuda) for x in random_box_case(1, 16, 4, seed=0))
  with pytest.raises(TypeError):
    raycast_boxes(o, d.double(), bx)
  with pytest.raises(ValueError):
    raycast_boxes(o, d.transpose(0, 1), bx)
  with pytest.raises(ValueError):
    raycast_boxes(o, d, bx[..., :8].contiguous())
