"""What the benchmark may import: nothing of JAX or the JAX package anywhere
under ``portbench/``, and nothing of the program in its reference. Top-level
module names are compared whole (``dad3dheads_tpu_torch`` is not
``dad3dheads_tpu``)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "optax", "dad3dheads_tpu"}


def imported_top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    assert "dad3dheads_tpu_torch" not in imported_top_levels(path)
    # relative imports stay inside the reference package
    assert all(node.level <= 1 for node in ast.walk(tree) if isinstance(node, ast.ImportFrom))


def test_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.network, portbench.reference.flame, "
            "portbench.reference.train, portbench.reference.precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'dad3dheads_tpu_torch', 'dad3dheads_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_run_checks_top_level_names_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "dad3dheads_tpu_torch_lookalike", sys)
    assert "dad3dheads_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in run.forbidden_modules()
