"""Port parity: the JAX -> torch bridge and the committed scene file.

The port has no scene builder yet. Its full-size runs load
``carla_garage_tpu_torch/data/synth_b16_v100_seed0.npz``, which
``write_synth_scene`` makes from the JAX package's ``make_synthetic_batch``.
Rewrite it with

  JAX_PLATFORMS=cpu python tests/test_torch_port_scene.py

The helpers here (``to_port``, ``jax_leaves``) are the test-only bridge
that the other ``test_torch_port_*`` files use to hand JAX structs to the
port as numpy arrays.
"""

import dataclasses
import os
import sys
import typing

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from carla_garage_tpu.config import DEFAULT_CONFIG  # noqa: E402
from carla_garage_tpu.sim.scene_builder import make_synthetic_batch  # noqa
from carla_garage_tpu_torch import scene_io  # noqa: E402
from carla_garage_tpu_torch.maps.town_map import LaneGraph, MapStack  # noqa
from carla_garage_tpu_torch.structs import (Scene, SimState,  # noqa: E402
                                            tree_items)

# the full-size scene: 16 episodes, 100 vehicle slots, 100 NPCs, 2 walkers
SYNTH_ARGS = dict(batch=16, seed=0, n_vehicles=100, n_walkers=2)


def synth_config(max_vehicles=100):
  return DEFAULT_CONFIG.replace(sim=dataclasses.replace(
      DEFAULT_CONFIG.sim, max_vehicles=max_vehicles))


def jax_leaves(obj, cls, prefix, out=None) -> dict:
  """{path: numpy array} of a JAX struct, walked by the field names of its
  port counterpart `cls` (fields the port lacks, like the JAX rng key, are
  left out; empty tuples are skipped)."""
  out = {} if out is None else out
  hints = typing.get_type_hints(cls)
  for f in dataclasses.fields(cls):
    v = getattr(obj, f.name)
    key = f"{prefix}/{f.name}"
    if dataclasses.is_dataclass(hints[f.name]):
      jax_leaves(v, hints[f.name], key, out)
    elif not (isinstance(v, tuple) and v == ()):
      out[key] = np.asarray(v)
  return out


def to_port(obj, cls, device="cpu"):
  """A JAX struct as the port's struct `cls`, leaf by leaf through numpy."""
  return scene_io._build(cls, "x", jax_leaves(obj, cls, "x"),
                         torch.device(device))


def jax_batch_to_port(maps, lanes, scene, state, device="cpu"):
  return (to_port(maps, MapStack, device), to_port(lanes, LaneGraph, device),
          to_port(scene, Scene, device), to_port(state, SimState, device))


def write_synth_scene(path=scene_io.SYNTH_B16_V100):
  """Write the committed full-size scene from the JAX builder."""
  _, maps, lanes, scene, state = make_synthetic_batch(synth_config(),
                                                      **SYNTH_ARGS)
  scene_io.save_scene(path, *jax_batch_to_port(maps, lanes, scene, state))


def test_committed_scene_matches_jax_builder():
  _, maps, lanes, scene, state = make_synthetic_batch(synth_config(),
                                                      **SYNTH_ARGS)
  loaded = scene_io.load_scene(device="cpu")
  n = 0
  for name, jx, cls, port in zip(("maps", "lanes", "scene", "state"),
                                 (maps, lanes, scene, state),
                                 (MapStack, LaneGraph, Scene, SimState),
                                 loaded):
    want = jax_leaves(jx, cls, name)
    got = dict(tree_items(port, name))
    assert set(want) == set(got), name
    for key, w in want.items():
      g = got[key].numpy()
      # the file stores the builder's arrays as they are: exact equality
      assert g.dtype == w.dtype and g.shape == w.shape, key
      np.testing.assert_array_equal(g, w, err_msg=key)
      n += 1
  assert n > 80
  assert loaded[3].vehicles.pos.shape == (16, 100, 2)
  assert int(loaded[3].vehicles.valid.sum()) > 0


def test_load_scene_refuses_cuda_without_a_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    scene_io.load_scene()


if __name__ == "__main__":
  write_synth_scene()
  print("wrote", scene_io.SYNTH_B16_V100)
