"""What the benchmark may import. No module under bench/ that the chip runs
imports jax, jaxlib, flax or the JAX package ``repro`` (top-level names
compared whole: ``repro_torch`` is not ``repro``); the reference imports
nothing of the program or of the harness."""
import ast

import pytest

from smoke import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


CHIP_MODULES = sorted(p for p in BENCH.rglob("*.py")
                      if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", CHIP_MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_what_the_chip_runs(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names
    assert not names & {"benchkit", "metrics", "work"}


def test_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types
    import run
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "repro_torchx", types.ModuleType("x"))
    assert run.forbidden_modules() == ["repro"]
