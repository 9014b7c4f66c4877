"""The check that JAX and the JAX package are not loaded compares whole
top-level module names; nothing under portbench imports them."""

import ast
import sys
import types

from portbench import harness


def test_whole_name_guard(monkeypatch):
  for name in ("carla_garage_tpu_torch", "carla_garage_tpu_torch.sim",
               "jaxtyping", "flaxen", "jax_like"):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
  assert harness.forbidden_loaded() == []
  monkeypatch.setitem(sys.modules, "carla_garage_tpu.sim",
                      types.ModuleType("carla_garage_tpu.sim"))
  monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
  assert harness.forbidden_loaded() == ["carla_garage_tpu", "jaxlib"]


def test_no_file_imports_them():
  bad = set(harness.FORBIDDEN_MODULES)
  for f in harness.PKG.rglob("*.py"):
    tree = ast.parse(f.read_text())
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom) and node.module:
        names = [node.module]
      else:
        continue
      assert not {n.split(".")[0] for n in names} & bad, (f, names)


def test_a_run_refuses_them(monkeypatch):
  """A run that ends with JAX loaded raises instead of printing a result
  (the command line then exits with 2)."""
  import pytest
  from portbench.tests.helpers import tiny_run
  monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
  with pytest.raises(harness.HarnessError, match="jax"):
    tiny_run("plant.eval")
