"""The port stands alone: no file of consensus_specs_tpu_torch/ nor
chip_smoke.py imports jax or the JAX package, the kernel sources are in the
package, its build directory is git-ignored, it reads no CSTPU_* knob, and
its entry points refuse a missing card instead of falling back. And it is
complete: every module of the JAX package has a port file, and every
public top-level name of a module there has one in its port file, but for
the deliberate omissions listed here with their reasons (ROADMAP.md lists
the same names).

An AST scan, not sys.modules: the test process has jax imported already,
and neither package is imported to read its names."""
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
            "generators/__main__.py", "networking/messaging.py",
            "networking/rpc.py", "networking/identity.py",
            "deposit_contract/__init__.py", "deposit_contract/contract.py",
            "deposit_contract/native.py"} <= names
    assert (ROOT / "chip_smoke.py").exists()


def test_kernel_source_present_and_build_dir_ignored():
    from consensus_specs_tpu_torch.ops import _nvcc
    for name in ("sha256_pairs", "fq_mont", "fq_points"):
        assert (PKG / "csrc" / f"{name}.cu").is_file()
        assert name in _nvcc.SOURCES
    # the host library's source sits beside them and builds with g++, not nvcc
    assert (PKG / "csrc" / "deposit_tree.cpp").is_file()
    assert _nvcc.SOURCES == ("sha256_pairs", "fq_mont", "fq_points")
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "consensus_specs_tpu_torch/_build/" in ignored


def test_no_environment_knob():
    """The reference's CSTPU_* switches (reduction placement, scalar-mul
    backend and window, ...) have no counterpart in the port."""
    files = _sources() + sorted((PKG / "csrc").glob("*.c*"))
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


# ---------------------------------------------------------------------------
# Parity: the port lacks no module and no public name of the JAX package
# ---------------------------------------------------------------------------

REF = ROOT / "consensus_specs_tpu"

# Modules of the JAX package whose port file has another name, or none.
RENAMED = {"ops/sha256_pallas.py": "ops/sha256_cuda.py",   # the Pallas kernel -> CUDA
           "ops/bls_jax.py": "ops/bls_torch.py"}           # the JAX BLS backend
NOT_PORTED = {
    "utils/donation.py": "jax.jit twins that donate their inputs: eager torch "
                         "updates preallocated tensors in place instead",
}

ALIAS = "an import alias, not a name of the module's API"
ELSEWHERE = "a re-import: its twin lives in another port module"
SETTER = ("a backend setter, installer or hook: a hidden fallback or a plug into "
          "the reference, which the port forbids")
KNOB = "reads a CSTPU_ environment knob: the port has none"
CONTRACT = "a jaxpr contract registration or an XLA trace statistic"
TOWER = "a module function of the tower: a Tower method in the port"
XLA_ONLY = "exists for XLA only (donation, the JAX pair hasher, the traced pair hash)"

# module -> {reason: names}: the deliberate omissions, name for name
OMITTED = {
    "models/phase0/epoch_soa.py": {
        ALIAS: {"partial", "u64"}, XLA_ONLY: {"platform_donated_jit"},
        CONTRACT: {"MEM_CONTRACTS", "RANGE_CONTRACTS", "TRACE_CONTRACTS"}},
    "models/phase0/helpers.py": {SETTER: {"set_shuffle_backend"}},
    "ops/decompress.py": {ALIAS: {"intmath"}},
    "ops/fq.py": {
        ALIAS: {"intmath", "partial"}, SETTER: {"set_fq_redc_backend"},
        KNOB: {"fq_redc_backend_name", "pinned_fq_redc_backend"},
        CONTRACT: {"RANGE_CONTRACTS", "redc_trace_stats", "reset_redc_trace_stats",
                   "staged_helpers"}},
    "ops/fq_tower.py": {
        CONTRACT: {"RANGE_CONTRACTS", "TRACE_CONTRACTS"},
        TOWER: {"fq12_add", "fq12_from_limbs", "fq12_to_limbs", "fq6_add",
                "fq6_from_limbs", "fq6_neg", "fq6_sub", "fq6_to_limbs", "fq6_zeros"}},
    "ops/scalar_mul.py": {
        SETTER: {"set_scalar_mul_backend"},
        KNOB: {"scalar_mul_backend_name", "scalar_mul_window"},
        CONTRACT: {"RANGE_CONTRACTS", "TRACE_CONTRACTS"}},
    "ops/sha256.py": {
        ALIAS: {"List"}, SETTER: {"install_device_hasher", "set_merkle_pair_backend"},
        KNOB: {"merkle_pair_backend_name"},
        CONTRACT: {"RANGE_CONTRACTS", "TRACE_CONTRACTS"},
        XLA_ONLY: {"jax_pair_hasher", "sha256_pairs_inner"}},
    "ops/shuffle.py": {
        ALIAS: {"partial"}, SETTER: {"install_device_shuffler"},
        CONTRACT: {"RANGE_CONTRACTS"}},
    "parallel/sharding.py": {
        ALIAS: {"Dict", "Mesh", "NamedSharding", "P", "partial"},
        ELSEWHERE: {"EpochReport", "RETRIES_DEFAULT"},
        CONTRACT: {"MEM_CONTRACTS", "TRACE_CONTRACTS"},
        XLA_ONLY: {"platform_donated_jit"}},
    "resilience/__init__.py": {ALIAS: {"Optional"}},
    "resilience/dispatch.py": {CONTRACT: {"TRACE_CONTRACTS"}},
    "resilience/integrity.py": {ALIAS: {"Callable"}, CONTRACT: {"TRACE_CONTRACTS"}},
    "streaming/pipeline.py": {
        CONTRACT: {"MEM_CONTRACTS", "TRACE_CONTRACTS"},
        XLA_ONLY: {"platform_donated_jit"}},
    "utils/hash.py": {ALIAS: {"Callable"}, SETTER: {"get_pair_hasher", "set_pair_hasher"}},
    "utils/ssz/incremental.py": {
        ELSEWHERE: {"zerohash_words"}, KNOB: {"merkle_pair_backend_name"},
        CONTRACT: {"MEM_CONTRACTS", "TRACE_CONTRACTS"},
        XLA_ONLY: {"platform_donated_jit", "sha256_pairs_inner"}},
}


def _public_names(path: Path) -> set:
    """Top-level public names of a module: functions, classes, assigned
    names, names imported with `from`, and the entries of `__all__`
    (starred tuples of string constants expanded). `import x` binds a
    module, not an API name, and is not counted."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out, strings = set(), {}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    out.update(e.id for e in ast.walk(target) if isinstance(e, ast.Name))
                value = node.value
                if isinstance(value, (ast.Tuple, ast.List)):
                    items = []
                    for e in value.elts:
                        if isinstance(e, ast.Constant) and isinstance(e.value, str):
                            items.append(e.value)
                        elif isinstance(e, ast.Starred) and isinstance(e.value, ast.Name):
                            items.extend(strings.get(e.value.id, ()))
                    for target in targets:
                        if isinstance(target, ast.Name):
                            strings[target.id] = items
            elif isinstance(node, ast.ImportFrom):
                out.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for handler in node.handlers:
                    visit(handler.body)
                visit(node.orelse)
                visit(node.finalbody)

    visit(tree.body)
    out.update(strings.get("__all__", ()))
    return {n for n in out if not n.startswith("_")}


def _reference_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def test_every_reference_module_has_a_port_file():
    missing = [rel for rel in _reference_modules()
               if rel not in NOT_PORTED and not (PKG / RENAMED.get(rel, rel)).is_file()]
    assert missing == []
    assert all((REF / rel).is_file() for rel in {**RENAMED, **NOT_PORTED})
    assert not any((PKG / rel).exists() for rel in NOT_PORTED)


@pytest.mark.parametrize("rel", [rel for rel in _reference_modules()
                                 if rel not in NOT_PORTED and rel not in RENAMED])
def test_port_has_every_public_name(rel):
    """The reference module's public names, less the port file's, are
    exactly the allowlisted omissions: a new gap fails, and so does an
    allowlisted name the port has come to define."""
    lacking = _public_names(REF / rel) - _public_names(PKG / rel)
    allowed = set().union(*OMITTED.get(rel, {}).values())
    assert lacking - allowed == set(), f"{rel}: the port lacks {sorted(lacking - allowed)}"
    assert allowed - lacking == set(), \
        f"{rel}: no longer omitted, take off the list: {sorted(allowed - lacking)}"


def test_omissions_name_modules_of_the_reference():
    assert set(OMITTED) <= set(_reference_modules())
    assert all(names for reasons in OMITTED.values() for names in reasons.values())
