"""What the benchmark imports: nothing of JAX or the JAX package anywhere,
and nothing of the program under test in the reference."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PKG = Path(harness.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "deepinpainting_tpu"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path):
    """(top-level name, level) of every import statement of a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    names = {n for n, level in _imports(path) if level == 0}
    assert not names & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in _imports(path):
        assert level <= 1, "the reference imports only within itself"
        assert name not in {"deepinpainting_torch", "portbench"} | FORBIDDEN


def test_loaded_modules_after_a_run_hold_no_jax(tmp_path):
    """A whole run of a cell (the CPU at a tiny size), every reader
    loaded, then sys.modules compared by whole top-level names."""
    code = f"""
import sys
sys.path.insert(0, {str(PKG.parent)!r})
sys.path.insert(0, {str(PKG / 'tests')!r})
from conftest import OPEN_LOOP, TINY, tiny_cell
from portbench import harness, calibrate, sweep
for name in ("train-256-f32", OPEN_LOOP):
    cell = tiny_cell(name)
    harness.run_cell(cell, 11, 0.5, True, "cpu", cfg_override=TINY)
for kind in ("metrics", "end_to_end"):
    for p in sorted((harness.HERE / kind).glob("*.py")):
        harness.load_reader(kind, p.stem)
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("LOADED")][-1]
    loaded = set(ast.literal_eval(line[len("LOADED "):]))
    assert "deepinpainting_torch" in loaded
    assert not loaded & FORBIDDEN
    assert harness.forbidden_modules(["jax.numpy", "deepinpainting_tpu.ops",
                                      "deepinpainting_torch", "jaxtyping"]) \
        == ["deepinpainting_tpu", "jax"]
