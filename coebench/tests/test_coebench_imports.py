"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's ``repro_torch`` begins with ``repro``),
and the references import nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})
    assert "coebench" not in top_level_imports(path) or \
        path.name == "__init__.py"


def test_the_check_sees_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import x\n")
    assert top_level_imports(bad) == {"jax", "repro"}
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch\nfrom repro_torch.core import x\n")
    assert not top_level_imports(ok) & FORBIDDEN
