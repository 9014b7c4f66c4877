"""Port parity: the JAX -> torch bridge and the committed scene file.

``carla_garage_tpu_torch/data/synth_b16_v100_seed0.npz`` holds a scene
that ``write_synth_scene`` makes from the JAX package's
``make_synthetic_batch`` (the port's own builder is tested in
``test_torch_port_scenarios.py``). Rewrite it with

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
  left out; empty tuples are skipped; an optional sub-struct, such as the
  scenario specs, is walked when present)."""
  out = {} if out is None else out
  hints = typing.get_type_hints(cls)
  for f in dataclasses.fields(cls):
    v = getattr(obj, f.name)
    key = f"{prefix}/{f.name}"
    if isinstance(v, tuple) and v == ():
      continue
    sub, _ = scene_io.field_struct(hints[f.name])
    if sub is not None:
      jax_leaves(v, sub, key, out)
    else:
      out[key] = np.asarray(v)
  return out


def to_port(obj, cls, device="cpu"):
  """A JAX struct as the port's struct `cls`, leaf by leaf through numpy."""
  return scene_io._build(cls, "x", jax_leaves(obj, cls, "x"),
                         torch.device(device))


def clear_jax_town_caches():
  """Empty the JAX scene builder's per-town caches, before a JAX build
  that a test holds against the port's. They are keyed by
  id(town.raster) and keep the entries of freed rasters, which a new
  raster at a reused address is then served: a town that an earlier test
  in the process freed would lend its snap map or router to the new one
  (the port drops an entry with its raster)."""
  from carla_garage_tpu.sim import scene_builder as j_sb
  for cache in (j_sb._SNAP_CACHE, j_sb._LANE_SNAP_CACHE, j_sb._ROUTER_CACHE):
    cache.clear()


def jax_batch_to_port(maps, lanes, scene, state, device="cpu"):
  return (to_port(maps, MapStack, device), to_port(lanes, LaneGraph, device),
          to_port(scene, Scene, device), to_port(state, SimState, device))


def write_synth_scene(path=scene_io.SYNTH_B16_V100):
  """Write the committed full-size scene from the JAX builder."""
  _, maps, lanes, scene, state = make_synthetic_batch(synth_config(),
                                                      **SYNTH_ARGS)
  scene_io.save_scene(path, *jax_batch_to_port(maps, lanes, scene, state))


def test_committed_scene_matches_jax_builder():
  clear_jax_town_caches()
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


def test_scenarios_survive_the_bridge_and_the_file(tmp_path):
  """A JAX scene with scenarios keeps its specs and trigger state through
  the test bridge and through save_scene / load_scene, leaf for leaf."""
  from carla_garage_tpu.sim.scene_builder import make_town_batch
  from carla_garage_tpu_torch.structs import ScenarioSpecs, ScenarioState
  _, maps, lanes, scene, state = make_town_batch(
      synth_config(16), "synth", batch=2, seed=2, n_vehicles=4,
      n_walkers=1, use_scenarios=True)
  assert scene.scenarios != () and state.scenario != ()
  ported = jax_batch_to_port(maps, lanes, scene, state)
  path = tmp_path / "scene.npz"
  scene_io.save_scene(path, *ported)
  for _, _, t_scene, t_state in (ported, scene_io.load_scene(path, "cpu")):
    assert isinstance(t_scene.scenarios, ScenarioSpecs)
    assert isinstance(t_state.scenario, ScenarioState)
    for jx, port, cls in ((scene.scenarios, t_scene.scenarios,
                           ScenarioSpecs),
                          (state.scenario, t_state.scenario, ScenarioState)):
      want = jax_leaves(jx, cls, "")
      got = dict(tree_items(port, ""))
      assert set(want) == set(got) and len(want) >= 3
      for key, w in want.items():
        assert got[key].numpy().dtype == w.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
  assert bool(t_scene.scenarios.valid.any())
  # a scene without scenarios still loads with the empty default
  assert scene_io.load_scene(device="cpu")[2].scenarios == ()


def test_load_scene_refuses_cuda_without_a_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    scene_io.load_scene()


if __name__ == "__main__":
  write_synth_scene()
  print("wrote", scene_io.SYNTH_B16_V100)
