"""No file of the benchmark imports JAX or the JAX package; the reference
and the generators import nothing of the program either. Top-level module
names are compared whole: consensus_specs_tpu_torch is not
consensus_specs_tpu."""
import ast

import pytest

from .conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "consensus_specs_tpu"}
PURE = ("reference", "gen")
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_scan_tells_the_port_from_the_jax_package():
    assert "consensus_specs_tpu_torch".split(".")[0] not in FORBIDDEN
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_pure_reference(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path.relative_to(BENCH).parts[0] in PURE:
        assert "consensus_specs_tpu_torch" not in names
        assert "torch" not in names
