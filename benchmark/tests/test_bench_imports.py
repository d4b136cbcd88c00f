"""The import rule: nothing under benchmark/ imports JAX, flax or the
JAX package, and the references import nothing of the measured package,
by top-level name compared whole."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "vocal_remover_tpu"}


def imported_top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = ""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_side_imports(path):
    assert not imported_top_names(path) & JAX_SIDE


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported_top_names(path)
    assert "vocal_remover_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "numpy", "torch", "benchmark"}


def test_whole_name_comparison():
    assert run.loaded_forbidden({"vocal_remover_tpu_torch": 0,
                                 "vocal_remover_tpu_torch.nn": 0,
                                 "jaxtyping": 0, "flaxen": 0}) == []
    assert run.loaded_forbidden({"vocal_remover_tpu.nn.lstm": 0,
                                 "jax._src": 0, "flax": 0, "jaxlib": 0}) == [
        "flax", "jax", "jaxlib", "vocal_remover_tpu"]


def test_imports_reach_no_jax_side(tmp_path):
    """A fresh interpreter that imports the harness, every driver and every
    reader loads nothing of the JAX side."""
    import subprocess
    import sys

    code = (
        "import sys; from benchmark import harness, check_serve, "
        "check_train, serve_common\n"
        "import glob, os\n"
        "for f in glob.glob('benchmark/drivers/*.py'): harness.driver("
        "os.path.basename(f)[:-3])\n"
        "for f in glob.glob('benchmark/metrics/*.py'): harness.reader("
        "os.path.basename(f)[:-3])\n"
        "from benchmark import run\n"
        "print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
