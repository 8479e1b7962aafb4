"""No module of the benchmark imports the JAX stack, and the plain
reference imports nothing of the program: top-level module names are
compared whole, so ``lightcurver_tpu_torch`` is not ``lightcurver_tpu``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "lightcurver_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_jax_stack(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "lightcurver_tpu_torch" not in top_level_imports(path)


def test_the_guard_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import lightcurver_tpu_torch.ops\n"
                     "from jax.numpy import zeros\n")
    assert top_level_imports(probe) & FORBIDDEN == {"jax"}
