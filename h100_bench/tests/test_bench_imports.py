"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either. Module names are
compared by their whole top-level name (the part before the first dot):
the program's name begins with the JAX package's.

One CPU test is let through by name: ``test_bench_reference_vs_jax.py``
holds the reference against the JAX package, the system's specification.
It is a test module, which nothing a benchmark run loads imports."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "track_analyser_tpu"}
PROGRAM = "track_analyser_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


SPECIFICATION_TEST = BENCH / "tests" / "test_bench_reference_vs_jax.py"


def modules(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", [p for p in modules(BENCH) if p != SPECIFICATION_TEST],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax(path):
    assert not top_level_imports(path) & JAX_NAMES


def test_nothing_imports_the_specification_test():
    name = SPECIFICATION_TEST.stem
    assert SPECIFICATION_TEST.exists()
    for path in modules(BENCH):
        assert name not in path.read_text() or path in (SPECIFICATION_TEST, Path(__file__)), path


@pytest.mark.parametrize("path", modules(BENCH / "reference"), ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX_NAMES | {PROGRAM})


def test_the_walk_sees_what_it_must_reject(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom track_analyser_tpu.utils import x\n"
                   "from track_analyser_tpu_torch import y\nimport importlib\nimportlib.import_module('jaxlib')\n")
    assert top_level_imports(bad) == {"jax", "track_analyser_tpu", "track_analyser_tpu_torch", "importlib", "jaxlib"}
