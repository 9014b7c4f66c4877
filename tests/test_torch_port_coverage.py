"""The port covers the JAX package: every public top-level function and
class of ``carla_garage_tpu/`` and every file of the root ``scripts/`` has
a same-named counterpart under ``carla_garage_tpu_torch/``, or is closed
below with its reason. Both packages are read with ``ast``; neither is
imported."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "carla_garage_tpu", ROOT / "carla_garage_tpu_torch"

# JAX names with no same-named port counterpart, each with the reason
CLOSED = {
    "load_reference_module": "serves only the seed's tests of the absent "
                             "reference code (convert/reference_modules.py)",
    "t2n": "a one-line numpy helper of the torch importer",
    "jax_tree_slice": "the port's counterpart is eval/benchmark.tree_slice",
    "group_norm_stats": "a TPU-only form of GroupNorm (TpuGroupNorm is "
                        "ported)",
    "fill_boxes_bev_reference": "the port's counterpart is "
                                "ops/bev_fill.fill_boxes_bev_plain",
    "zero1_spec": "ZeroRedundancyOptimizer fills its role",
    "zero1_shard_opt_state": "ZeroRedundancyOptimizer fills its role",
    "ray_box": "only the dense fallback _cast_rays_dense calls it; "
               "raycast_boxes_plain fills that role",
    "voxelize_matmul": "a TPU-only form of voxelize (ported)",
    "Throughput": "nothing of the port read it; the program's spans "
                  "(utils/profiling.span) and the benchmark time the loop",
}
CLOSED_SCRIPTS = {
    "validate_signals.py": "needs the reference's OpenDRIVE annotations",
    "xplane_optable.py": "reads TPU XProf traces",
    "bisect_fault.py": "bisects the v5e's own device faults "
                       "(docs/DEVICE_FAULT.md)",
    "run_r5_tf_benchmarks.sh": "a shell wrapper that drives the JAX scripts",
    "supervise.sh": "a shell wrapper that drives the JAX scripts",
}


def top_level_names(root: pathlib.Path, public: bool) -> dict:
  """{name: "file:line"} of the top-level functions and classes of every
  module under root (only the public ones when `public`)."""
  out = {}
  for path in sorted(root.rglob("*.py")):
    for node in ast.parse(path.read_text()).body:
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)) and \
          not (public and node.name.startswith("_")):
        out.setdefault(node.name,
                       f"{path.relative_to(ROOT)}:{node.lineno}")
  return out


def test_every_jax_name_and_script_has_a_port_counterpart():
  jax_names = top_level_names(JAX, public=True)
  port_names = top_level_names(PORT, public=False)
  missing = {n: where for n, where in jax_names.items()
             if n not in port_names and n not in CLOSED}
  assert not missing, missing
  scripts = {p.name for p in (ROOT / "scripts").iterdir() if p.is_file()}
  ported = {p.name for p in (PORT / "scripts").glob("*.py")}
  assert not scripts - ported - set(CLOSED_SCRIPTS), \
      scripts - ported - set(CLOSED_SCRIPTS)
  assert {"bench_forward.py", "merge_seed_runs.py"} <= ported


def test_closed_names_are_exactly_the_unported_ones():
  """CLOSED holds no stale entry: each closed name is a public JAX name the
  port lacks, and each closed script exists and has no port file."""
  jax_names = top_level_names(JAX, public=True)
  port_names = top_level_names(PORT, public=False)
  assert {n for n in jax_names if n not in port_names} == set(CLOSED)
  assert all(CLOSED.values()) and all(CLOSED_SCRIPTS.values())
  for name in CLOSED_SCRIPTS:
    assert (ROOT / "scripts" / name).is_file(), name
    assert not (PORT / "scripts" / name).exists(), name
