"""Result analytics: per-town infraction maps and replay clips (port of
carla_garage_tpu/eval/analysis.py; host side).

The criteria's event log (``CriteriaState.event_*``) carries every scored
infraction's position, kind (``structs.EventKind``) and tick, and
``sim/episode.rollout_recorded`` captures decimated trajectories. This
module turns both into the result parser's artifacts:

  infraction_map(...)   one PNG per town, all events color-coded by kind
  replay_clip(...)      an animated GIF around one infraction
  write_analysis(...)   writes both for a benchmark's records

The drawing functions import matplotlib when called, and only then.
"""

from __future__ import annotations

import os

import numpy as np

from carla_garage_tpu_torch.structs import EventKind

EVENT_STYLE = {
    EventKind.COLLISION_VEHICLE: ("collision_vehicle", "red", "x"),
    EventKind.COLLISION_WALKER: ("collision_walker", "magenta", "x"),
    EventKind.COLLISION_STATIC: ("collision_static", "orange", "x"),
    EventKind.RED_LIGHT: ("red_light", "lime", "o"),
    EventKind.STOP_SIGN: ("stop_sign", "cyan", "^"),
}


def events_from_criteria(cr, index: int) -> list:
  """Episode `index`'s event log as a list of {pos, kind, tick} dicts.
  Pass criteria already on the host to make no device copy per call."""
  n = int(cr.event_count[index])
  pos = cr.event_pos[index].cpu().numpy()
  kind = cr.event_kind[index].cpu().numpy()
  tick = cr.event_tick[index].cpu().numpy()
  return [{"pos": pos[i].tolist(), "kind": int(kind[i]),
           "tick": int(tick[i])} for i in range(n)]


def _town_axes(ax, raster, world_offset, ppm):
  h, w = raster.shape[-2:]
  ext = [world_offset[0], world_offset[0] + w / ppm,
         world_offset[1] + h / ppm, world_offset[1]]
  road = raster[0] if raster.ndim == 3 else raster
  ax.imshow(road > 0, cmap="gray", extent=ext)
  return ax


def infraction_map(town_name: str, raster, world_offset, ppm,
                   events: list, routes: list | None, path: str):
  """Town map PNG with every infraction event (the result parser's
  maps)."""
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  fig, ax = plt.subplots(figsize=(12, 12))
  _town_axes(ax, raster, world_offset, ppm)
  if routes:
    for r in routes:
      ax.plot(r[:, 0], r[:, 1], "-", color="yellow", lw=0.6, alpha=0.6)
  seen = set()
  for ev in events:
    name, color, marker = EVENT_STYLE.get(ev["kind"],
                                          ("other", "white", "."))
    ax.scatter([ev["pos"][0]], [ev["pos"][1]], c=color, marker=marker,
               s=60, label=None if name in seen else name)
    seen.add(name)
  if seen:
    ax.legend(loc="upper right")
  ax.set_title(f"{town_name}: {len(events)} infractions")
  fig.savefig(path, dpi=90, bbox_inches="tight")
  plt.close(fig)


def replay_clip(raster, world_offset, ppm, traj, episode: int,
                event: dict, path: str, window_s: float = 5.0,
                every: int = 10, fps: int = 20) -> bool:
  """Animated GIF of the recorded trajectory around one infraction (the
  result parser's clip re-rendering). traj: {name: numpy [T,B,...]} as
  ``rollout_recorded`` snapshots it. False when the window holds fewer
  than two frames."""
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  from matplotlib import animation

  ego = np.asarray(traj["ego"])[:, episode]          # [T,4]
  vp = np.asarray(traj["veh_pos"])[:, episode]
  vv = np.asarray(traj["veh_valid"])[:, episode]
  wp = np.asarray(traj["wlk_pos"])[:, episode]
  wv = np.asarray(traj["wlk_valid"])[:, episode]
  ticks = np.asarray(traj["tick"])[:, episode]
  t_ev = event["tick"]
  half = int(window_s * fps / every)
  center = int(np.argmin(np.abs(ticks - t_ev)))
  f0, f1 = max(center - half, 0), min(center + half, len(ego))
  if f1 - f0 < 2:
    return False

  fig, ax = plt.subplots(figsize=(6, 6))
  _town_axes(ax, raster, world_offset, ppm)
  ex, ey = event["pos"]
  ax.set_xlim(ex - 50, ex + 50)
  ax.set_ylim(ey + 50, ey - 50)
  name, color, marker = EVENT_STYLE.get(event["kind"],
                                        ("other", "white", "."))
  ax.scatter([ex], [ey], c=color, marker=marker, s=90)
  ax.set_title(name)
  ego_dot, = ax.plot([], [], "r s", ms=7)
  trail, = ax.plot([], [], "r-", lw=1)
  veh_sc = ax.scatter([], [], c="blue", s=22)
  wlk_sc = ax.scatter([], [], c="magenta", s=14)

  def update(fi):
    f = f0 + fi
    ego_dot.set_data([ego[f, 0]], [ego[f, 1]])
    trail.set_data(ego[f0:f + 1, 0], ego[f0:f + 1, 1])
    veh_sc.set_offsets(vp[f][vv[f]] if vv[f].any() else
                       np.zeros((0, 2)))
    wlk_sc.set_offsets(wp[f][wv[f]] if wv[f].any() else
                       np.zeros((0, 2)))
    return ego_dot, trail, veh_sc, wlk_sc

  ani = animation.FuncAnimation(fig, update, frames=f1 - f0, blit=True)
  ani.save(path, writer=animation.PillowWriter(fps=max(fps // every, 2)))
  plt.close(fig)
  return True


def write_analysis(outdir: str, towns: dict, per_town_events: dict,
                   per_town_routes: dict | None = None,
                   per_town_traj: dict | None = None,
                   max_clips_per_town: int = 4) -> list:
  """An infraction map PNG per town, and replay clips when trajectories
  were recorded. towns: {name: (raster, world_offset, ppm)};
  per_town_events: {name: [(episode_index, [events...]), ...]}. Returns
  the paths written."""
  os.makedirs(outdir, exist_ok=True)
  written = []
  for name, (raster, off, ppm) in towns.items():
    evs = [e for _, lst in per_town_events.get(name, []) for e in lst]
    p = os.path.join(outdir, f"infractions_{name}.png")
    infraction_map(name, raster, off, ppm, evs,
                   (per_town_routes or {}).get(name), p)
    written.append(p)
    if per_town_traj and name in per_town_traj:
      traj = per_town_traj[name]
      n = 0
      for epi, lst in per_town_events.get(name, []):
        for j, ev in enumerate(lst):
          if n >= max_clips_per_town:
            break
          cp = os.path.join(
              outdir, f"clip_{name}_ep{epi}_{j}_"
              f"{EVENT_STYLE.get(ev['kind'], ('other',))[0]}.gif")
          if replay_clip(raster, off, ppm, traj, epi, ev, cp):
            written.append(cp)
            n += 1
  return written
