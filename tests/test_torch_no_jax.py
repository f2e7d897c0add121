"""The port stands alone: no file of consensus_specs_tpu_torch/ nor
chip_smoke.py imports jax or the JAX package, the kernel sources are in the
package, its build directory is git-ignored, it reads no CSTPU_* knob, and
its entry points refuse a missing card instead of falling back.

An AST scan, not sys.modules: the test process has jax imported already."""
import ast
from pathlib import Path

import pytest
import torch

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
            "models/phase0/resident.py", "ops/fq.py", "ops/fq_cuda.py",
            "ops/fq_tower.py", "ops/scalar_mul.py", "ops/decompress.py",
            "ops/bls_torch.py", "crypto/bls12_381.py",
            "utils/ssz/typing.py", "utils/ssz/impl.py", "utils/ssz/columns.py",
            "crypto/bls.py", "models/phase0/containers.py",
            "models/phase0/helpers.py", "models/phase0/block.py",
            "models/phase0/epoch.py", "models/phase0/spec.py",
            "telemetry/core.py", "telemetry/watchdog.py", "telemetry/export.py",
            "telemetry/__init__.py", "resilience/errors.py",
            "resilience/dispatch.py", "streaming/_metrics.py",
            "streaming/queue.py", "streaming/pipeline.py",
            "streaming/verifier.py", "streaming/__init__.py",
            "networking/gossip.py", "models/phase0/validator.py",
            "models/phase0/fork_choice.py", "resilience/faults.py",
            "resilience/integrity.py", "resilience/checkpoint.py",
            "resilience/__init__.py", "api/__init__.py",
            "api/beacon_node.py", "models/phase1/__init__.py",
            "models/phase1/constants.py", "models/phase1/containers.py",
            "models/phase1/custody.py", "models/phase1/shard.py",
            "models/phase1/spec.py", "light_client/__init__.py",
            "light_client/multiproof.py",
            "light_client/sync_protocol.py", "parallel/__init__.py",
            "parallel/sharding.py", "parallel/exchange.py",
            "debug/encode.py", "debug/decode.py", "debug/random_value.py",
            "fuzzing/sedes.py", "fuzzing/decoder.py", "testing/utils.py",
            "testing/keys.py", "testing/context.py", "testing/factories.py",
            "testing/runners.py", "testing/cases/__init__.py",
            "testing/cases/attestation.py", "testing/cases/finality.py",
            "testing/cases/sanity_blocks.py", "generators/base.py",
            "generators/from_tables.py", "generators/suites.py",
            "generators/__main__.py"} <= names
    assert (ROOT / "chip_smoke.py").exists()


def test_kernel_source_present_and_build_dir_ignored():
    from consensus_specs_tpu_torch.ops import _nvcc
    for name in ("sha256_pairs", "fq_mont"):
        assert (PKG / "csrc" / f"{name}.cu").is_file()
        assert name in _nvcc.SOURCES
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "consensus_specs_tpu_torch/_build/" in ignored


def test_no_environment_knob():
    """The reference's CSTPU_* switches (reduction placement, scalar-mul
    backend and window, ...) have no counterpart in the port."""
    files = _sources() + sorted((PKG / "csrc").glob("*.cu"))
    assert [p.name for p in files if "CSTPU_" in p.read_text()] == []


def test_bls_backend_refuses_missing_cuda():
    from consensus_specs_tpu_torch.ops.bls_torch import TorchBackend
    if torch.cuda.is_available():
        assert TorchBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchBackend()
        with pytest.raises(RuntimeError):
            TorchBackend(device="cuda")
    assert TorchBackend(device="cpu").device.type == "cpu"


def test_generators_refuse_missing_cuda(tmp_path):
    """cases_from_table and the generator CLI run the specs on the card
    unless told `--device cpu` / device="cpu": without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from consensus_specs_tpu_torch.generators.__main__ import main
    from consensus_specs_tpu_torch.generators.from_tables import cases_from_table, table
    with pytest.raises(RuntimeError):
        cases_from_table(table("sanity_slots"), "minimal", bls_default=False)
    with pytest.raises(RuntimeError):
        main(["-o", str(tmp_path), "-p", "minimal", "--family", "shuffling"])
    with pytest.raises(RuntimeError):
        main(["-o", str(tmp_path), "-p", "mainnet", "--family", "bls"])
    assert not (tmp_path / "tests").exists()
    main(["-o", str(tmp_path), "-p", "minimal", "--family", "shuffling", "--device", "cpu"])
    assert (tmp_path / "tests").exists()
