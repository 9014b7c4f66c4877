"""Faults planted in the program, for reading what ``correct`` compares
when the timed path is broken underneath: the tests' fault runs on the
CPU and ``python3 -m portbench.calibrate --fault <name>`` at a cell's own
size on the card.

Each fault is a function of the run's context that replaces a name in a
program module (or wraps the configuration's builder) and returns a
function that undoes it.
"""

from __future__ import annotations

import importlib

import torch


def _swap(module: str, name: str, make):
  mod = importlib.import_module(module)
  real = getattr(mod, name)
  setattr(mod, name, make(real))
  return lambda: setattr(mod, name, real)


def _halve(tree, n):
  """The first n//2 rows of every tensor whose leading size is n."""
  from carla_garage_tpu_torch.structs import tree_map
  return tree_map(lambda x: x[:n // 2] if x.ndim and x.shape[0] == n
                  else x, tree)


def eval_state_unchanged(ctx):
  """The tick runs, and the step returns the state it was given."""
  def make(real):
    def step(cfg, maps, lanes, scene, state, policy=None, generator=None,
             draws=None):
      real(cfg, maps, lanes, scene, state, policy, generator=generator,
           draws=draws)
      return state
    return step
  return _swap("carla_garage_tpu_torch.sim.episode", "sim_step", make)


def eval_half_batch(ctx):
  """The second half of the episodes keeps its state."""
  from carla_garage_tpu_torch.structs import tree_map

  def make(real):
    def step(cfg, maps, lanes, scene, state, policy=None, generator=None,
             draws=None):
      new = real(cfg, maps, lanes, scene, state, policy,
                 generator=generator, draws=draws)
      h = state.tick.shape[0] // 2
      return tree_map(lambda a, b: torch.cat([a[:h], b[h:]])
                      if a.ndim and a.shape[0] == 2 * h else a, new, state)
    return step
  return _swap("carla_garage_tpu_torch.sim.episode", "sim_step", make)


def eval_control_altered(ctx):
  """The direct controller's steering off by 0.05 where it is made."""
  undo = []
  for module in ("carla_garage_tpu_torch.agents.plant_agent",
                 "carla_garage_tpu_torch.agents.sensor_agent"):
    def make(real):
      def control(*args, **kwargs):
        steer, throttle, brake, pt, ps = real(*args, **kwargs)
        return steer + 0.05, throttle, brake, pt, ps
      return control
    undo.append(_swap(module, "control_pid_direct", make))
  return lambda: [u() for u in undo]


def eval_sensor_altered(ctx):
  """The LiDAR half sweep's points shifted by 5 cm where they are made."""
  def make(real):
    def render(*args, **kwargs):
      pts, valid = real(*args, **kwargs)
      return pts + 0.05, valid
    return render
  return _swap("carla_garage_tpu_torch.agents.sensor_agent", "render_lidar",
               make)


def train_state_unchanged(ctx):
  """The optimizer's step does nothing."""
  build = ctx.config.train_build

  def frozen(ctx_, traffic):
    tr = build(ctx_, traffic)
    tr.optimizer.step = lambda *a, **k: None
    return tr

  ctx.config.train_build = frozen
  return lambda: setattr(ctx.config, "train_build", build)


_LOSSES = {"plant": ("carla_garage_tpu_torch.train.plant_train",
                     "plant_loss"),
           "tfpp": ("carla_garage_tpu_torch.train.transfuser_train",
                    "transfuser_loss")}


def _batch_arg(args):
  """The position of the batch among a loss's arguments: the dict that
  holds the samples' speed (a model's parameters are a dict too)."""
  return next(i for i, a in enumerate(args) if isinstance(a, dict) and
              ("speed" in a or "velocity" in a))


def train_half_batch(ctx):
  """The loss sees the first half of the batch's rows, the mean taken
  over them."""
  def make(real):
    def loss(*args, **kwargs):
      args = list(args)
      i = _batch_arg(args)
      b = args[i]
      n = next(v.shape[0] for v in b.values()
               if isinstance(v, torch.Tensor) and v.ndim)
      args[i] = {k: _halve(v, n) for k, v in b.items()}
      return real(*args, **kwargs)
    return loss
  return _swap(*_LOSSES[ctx.config.CONFIG["name"]], make)


def train_loss_altered(ctx):
  """The loss, and its gradient, 1.5 times what it is."""
  def make(real):
    def loss(*args, **kwargs):
      total, aux = real(*args, **kwargs)
      return total * 1.5, dict(aux, loss=aux["loss"] * 1.5)
    return loss
  return _swap(*_LOSSES[ctx.config.CONFIG["name"]], make)


FAULTS = {f.__name__: f for f in (
    eval_state_unchanged, eval_half_batch, eval_control_altered,
    eval_sensor_altered, train_state_unchanged, train_half_batch,
    train_loss_altered)}
