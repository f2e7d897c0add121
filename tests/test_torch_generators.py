"""The port's conformance-vector generators (consensus_specs_tpu_torch.
generators) on the CPU.

Twins of the JAX package's tests/test_generators.py run against the port
(device="cpu"; a table row that forces BLS on signs through the port's
bignum "python" backend, since the default "torch" backend needs a card),
then the suite files the two packages write from the same creators, which
must be byte-identical: shuffling, ssz_static (phase 0 and phase 1) and
ssz_generic, and the BLS family at mainnet. Last, the generator's own
arguments: the tables resolve inside the port, and --accel (the bulk state
root on --device for the run) writes the same bytes as the host route and
leaves no hook installed."""
import importlib
import os
from pathlib import Path

import pytest
import yaml

from consensus_specs_tpu.generators import suites as JS
from consensus_specs_tpu.generators.base import write_suite as j_write_suite
import consensus_specs_tpu_torch
from consensus_specs_tpu_torch.generators import from_tables, suites
from consensus_specs_tpu_torch.generators.base import run_generator, write_suite
from consensus_specs_tpu_torch.generators.from_tables import cases_from_table, table
from consensus_specs_tpu_torch.models.phase0 import helpers as spec_helpers
from consensus_specs_tpu_torch.utils.ssz import bulk

from _bls_backend import python_bls  # noqa: F401
from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

CPU = "cpu"
_suites = {}


def _port_suite(creator, preset):
    """The port's suite of `creator` at `preset` on the CPU, built once a
    process (the ssz_static suites take seconds)."""
    key = (creator.__name__, preset)
    if key not in _suites:
        _suites[key] = creator(preset, device=CPU)
    return _suites[key]


# ---------------------------------------------------------------------------
# tests/test_generators.py, against the port
# ---------------------------------------------------------------------------

def test_operations_suite_replays_table(python_bls):
    cases = cases_from_table(table("block_header"), "minimal", bls_default=False,
                             device=CPU)
    assert len(cases) == 5
    ok = [c for c in cases if c.get("post") is not None]
    bad = [c for c in cases if c.get("post") is None]
    assert len(ok) >= 1 and len(bad) >= 3
    for c in cases:
        assert "pre" in c and "description" in c


def test_sanity_slots_suite():
    cases = cases_from_table(table("sanity_slots"), "minimal", bls_default=False,
                             device=CPU)
    assert len(cases) == 5
    for c in cases:
        assert isinstance(c["slots"], int)
        assert c["post"] is not None


def test_shuffling_suite_layout(tmp_path):
    suite = suites.shuffling_suite("minimal", device=CPU)
    path = write_suite(str(tmp_path), suite)
    assert path.endswith(os.path.join("tests", "shuffling", "core", "core_minimal.yaml"))
    with open(path) as fh:
        doc = yaml.safe_load(fh)
    for key in ("title", "summary", "forks_timeline", "forks", "config",
                "runner", "handler", "test_cases"):
        assert key in doc
    assert doc["runner"] == "shuffling"
    sizes = [c["count"] for c in doc["test_cases"]]
    assert sizes == sorted(sizes)
    for c in doc["test_cases"]:
        assert sorted(c["shuffled"]) == list(range(c["count"]))


def test_ssz_static_suite_roundtrips():
    suite = _port_suite(suites.ssz_static_suite, "minimal")
    assert suite.test_cases, "must emit cases for every container"
    names = {c["type_name"] for c in suite.test_cases}
    assert "BeaconState" in names and "Validator" in names
    for c in suite.test_cases[:20]:
        assert c["serialized"].startswith("0x")
        assert len(c["root"]) == 66


def test_run_generator_cli(tmp_path):
    out = run_generator(
        "shuffling", [suites.shuffling_suite],
        argv=["-o", str(tmp_path), "-p", "minimal", "--device", CPU])
    assert len(out) == 1
    assert os.path.exists(out[0])


def test_epoch_processing_suite():
    cases = cases_from_table(table("registry_updates"), "minimal", bls_default=False,
                             device=CPU)
    assert len(cases) == 4
    for c in cases:
        assert c["post"] is not None


def test_dry_run_writes_nothing(tmp_path):
    run_generator("shuffling", [suites.shuffling_suite],
                  argv=["-o", str(tmp_path), "-p", "minimal", "--dry", "--device", CPU])
    assert not os.path.exists(os.path.join(str(tmp_path), "tests"))


def test_ssz_generic_uint_suite_diffs_against_main_stack():
    """Every valid uint case decodes and re-encodes identically through the
    port's main SSZ stack (utils/ssz), not only the sedes codec that
    emitted it."""
    from consensus_specs_tpu_torch.utils.ssz import impl, typing as st

    suite = suites.ssz_generic_suite("mainnet")
    assert suite is not None and suites.ssz_generic_suite("minimal") is None
    widths = {c["type"] for c in suite.test_cases}
    assert widths == {f"uint{b}" for b in (8, 16, 32, 64, 128, 256)}
    uint_by_bits = {8: st.uint8, 16: st.uint16, 32: st.uint32,
                    64: st.uint64, 128: st.uint128, 256: st.uint256}
    n_valid = n_invalid = 0
    for c in suite.test_cases:
        bits = int(c["type"][4:])
        typ = uint_by_bits[bits]
        if c["valid"]:
            n_valid += 1
            raw = bytes.fromhex(c["ssz"][2:])
            assert len(raw) == bits // 8
            value = int(c["value"])
            assert impl.serialize(value, typ) == raw
            assert impl.deserialize(raw, typ) == value
        else:
            n_invalid += 1
            if "ssz" in c:
                raw = bytes.fromhex(c["ssz"][2:])
                assert len(raw) != bits // 8
            else:
                v = int(c["value"])
                assert v < 0 or v >= 2 ** bits
    assert n_valid >= 60 and n_invalid >= 36


def test_ssz_static_phase1_covers_extended_containers():
    suite = _port_suite(suites.ssz_static_phase1_suite, "minimal")
    names = {c["type_name"] for c in suite.test_cases}
    for required in ("BeaconState", "Validator", "ShardBlock",
                     "CustodyBitChallenge", "CustodyKeyReveal"):
        assert required in names, required
    assert suite.handler == "core_phase1" and suite.forks == ["phase1"]
    for c in suite.test_cases[:10]:
        assert c["serialized"].startswith("0x") and len(c["root"]) == 66


def test_cli_module_main(tmp_path):
    """`python -m consensus_specs_tpu_torch.generators` (family selection
    and argument passthrough)."""
    from consensus_specs_tpu_torch.generators.__main__ import main
    out = tmp_path / "v"
    main(["-o", str(out), "-p", "minimal", "--family", "shuffling", "--device", CPU])
    files = list(out.rglob("*.yaml"))
    assert files, "shuffling family must emit at least one suite file"


# ---------------------------------------------------------------------------
# Suite files: the port's bytes == the JAX package's
# ---------------------------------------------------------------------------

SUITE_FILES = {
    "shuffling": (suites.shuffling_suite, JS.shuffling_suite, "minimal"),
    "ssz_static": (suites.ssz_static_suite, JS.ssz_static_suite, "minimal"),
    "ssz_static_phase1": (suites.ssz_static_phase1_suite,
                          JS.ssz_static_phase1_suite, "minimal"),
    "ssz_generic": (suites.ssz_generic_suite, JS.ssz_generic_suite, "mainnet"),
}


def _same_files(tmp_path, port_suite, jax_suite):
    port = write_suite(str(tmp_path / "port"), port_suite)
    ref = j_write_suite(str(tmp_path / "jax"), jax_suite)
    assert os.path.relpath(port, tmp_path / "port") == os.path.relpath(ref, tmp_path / "jax")
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read(), port


@pytest.mark.parametrize("family", sorted(SUITE_FILES))
def test_suite_file_matches_the_jax_package(tmp_path, family):
    port_creator, jax_creator, preset = SUITE_FILES[family]
    _same_files(tmp_path, _port_suite(port_creator, preset), jax_creator(preset))


def test_bls_family_matches_the_jax_package(tmp_path):
    """The six BLS handlers at mainnet (host bignum curve in both packages),
    file for file; no BLS suite at minimal."""
    port, ref = suites.bls_creators(), JS.bls_creators()
    assert len(port) == len(ref) == 6
    for p, j in zip(port, ref):
        assert p("minimal", device=CPU) is None
        _same_files(tmp_path, p("mainnet", device=CPU), j("mainnet"))


# ---------------------------------------------------------------------------
# The generator's arguments
# ---------------------------------------------------------------------------

def test_tables_resolve_inside_the_port():
    """The string import path names the port's tables, never the JAX
    package's."""
    package = Path(consensus_specs_tpu_torch.__file__).parent
    assert from_tables.TABLE_ROOT == "consensus_specs_tpu_torch.testing.cases"
    for name in ("attestation", "sanity_blocks", "finality"):
        mod = importlib.import_module(table(name))
        assert Path(mod.__file__).is_relative_to(package / "testing" / "cases")


def test_accel_writes_the_host_route_bytes_and_removes_its_hook(tmp_path, python_bls,
                                                                 monkeypatch):
    """--accel roots every state of the run with the bulk root on --device
    (counted here) and writes the bytes of the host route (recursive
    roots); the hook is gone after the run, also after a failure."""
    calls = []
    real = bulk.state_root_bulk

    def counting(state, dev, pair_fn=None):
        calls.append(str(dev))
        return real(state, dev, pair_fn)

    monkeypatch.setattr(bulk, "state_root_bulk", counting)
    creators = suites.sanity_creators()[1:]                 # sanity/slots
    host = run_generator("sanity", creators,
                         ["-o", str(tmp_path / "host"), "-p", "minimal", "--device", CPU])
    assert calls == []
    accel = run_generator("sanity", creators, ["-o", str(tmp_path / "accel"), "-p",
                                               "minimal", "--device", CPU, "--accel"])
    assert calls and set(calls) == {"cpu"}
    assert spec_helpers._state_root_backend is None
    assert [os.path.relpath(p, tmp_path / "host") for p in host] == \
        [os.path.relpath(p, tmp_path / "accel") for p in accel]
    for a, b in zip(host, accel):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()

    def failing(preset, device="cuda"):
        raise ValueError("creator failed")

    with pytest.raises(ValueError):
        run_generator("x", [failing], ["-o", str(tmp_path / "f"), "-p", "minimal",
                                       "--device", CPU, "--accel"])
    assert spec_helpers._state_root_backend is None
