"""Nothing under benchmarks/ imports JAX, Flax or the JAX package, and
the reference imports nothing of the port; top-level module names are
compared whole (the port's name begins with the JAX package's)."""
import _paths  # noqa: F401
import ast
import pathlib
import sys
import types

import pytest

from harness import runtime

BENCH = pathlib.Path(_paths.BENCH)
JAX_SIDE = {"jax", "jaxlib", "flax", "photogrammetry_tpu"}


def imported(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not imported(path) & JAX_SIDE


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        got = imported(path)
        assert "photogrammetry_tpu_torch" not in got, path
        assert not got & {"harness", "drivers", "metrics"}, path


def test_loaded_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "photogrammetry_tpu_torch_fake",
                        types.ModuleType("x"))
    assert runtime.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "photogrammetry_tpu.sfm",
                        types.ModuleType("y"))
    assert runtime.forbidden_modules() == ["photogrammetry_tpu"]
