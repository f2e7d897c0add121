"""The port stands alone: no file of consensus_specs_tpu_torch/ nor
chip_smoke.py imports jax or the JAX package, the kernel source is in the
package, and its build directory is git-ignored.

An AST scan, not sys.modules: the test process has jax imported already."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "consensus_specs_tpu_torch"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "consensus_specs_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"ops/sha256.py", "ops/sha256_cuda.py",
            "models/phase0/resident.py"} <= names
    assert (ROOT / "chip_smoke.py").exists()


def test_kernel_source_present_and_build_dir_ignored():
    assert (PKG / "csrc" / "sha256_pairs.cu").is_file()
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "consensus_specs_tpu_torch/_build/" in ignored
