"""Suite builders for every vector family.

Families and handler naming per the reference's seven generators
(consensus-specs test_generators/{operations,epoch_processing,sanity,
shuffling,bls,ssz_static}/main.py) and their format docs under
specs/test_formats/. Operation/epoch/sanity suites replay the scenario
tables; shuffling/bls/ssz_static synthesize their cases directly. Port of
consensus_specs_tpu/generators/suites.py: every creator takes
`(preset, device="cuda")`, the device the suite's spec runs on; the BLS
family stays on the host bignum curve (crypto/bls12_381.py) and the
ssz_generic family on the sedes codec, so they ignore it.
"""
from __future__ import annotations

from random import Random
from typing import List

from ..crypto import bls12_381 as curve
from ..debug.encode import encode
from ..debug.random_value import RandomizationMode, get_random_ssz_object
from ..models import phase0
from ..utils.ssz.impl import hash_tree_root, serialize, signing_root
from .base import Suite
from .from_tables import cases_from_table, table

# ---------------------------------------------------------------------------
# Table-replay families
# ---------------------------------------------------------------------------

OPERATION_TABLES = {
    "attestation": "attestation",
    "attester_slashing": "attester_slashing",
    "block_header": "block_header",
    "deposit": "deposit",
    "proposer_slashing": "proposer_slashing",
    "transfer": "transfer",
    "voluntary_exit": "voluntary_exit",
}

EPOCH_TABLES = {
    "crosslinks": "crosslinks",
    "registry_updates": "registry_updates",
}

SANITY_TABLES = {
    "blocks": "sanity_blocks",
    "slots": "sanity_slots",
}


def _replay(runner: str, handler: str, module: str, preset: str,
            bls_default: bool = True, device="cuda") -> Suite:
    cases = cases_from_table(table(module), preset, bls_default=bls_default,
                             device=device)
    return Suite(
        title=f"{handler} {runner}",
        summary=f"{runner}/{handler} vectors generated from the scenario table",
        config=preset,
        runner=runner,
        handler=handler,
        test_cases=cases,
    )


def operations_creators():
    return [
        (lambda preset, device="cuda", h=h, m=m:
         _replay("operations", h, m, preset, device=device))
        for h, m in OPERATION_TABLES.items()
    ]


def epoch_processing_creators():
    return [
        (lambda preset, device="cuda", h=h, m=m:
         _replay("epoch_processing", h, m, preset, device=device))
        for h, m in EPOCH_TABLES.items()
    ]


def sanity_creators():
    return [
        (lambda preset, device="cuda", h=h, m=m:
         _replay("sanity", h, m, preset, device=device))
        for h, m in SANITY_TABLES.items()
    ]


# ---------------------------------------------------------------------------
# Shuffling
# ---------------------------------------------------------------------------

def shuffling_suite(preset: str, device="cuda") -> Suite:
    """Full swap-or-not permutations for a range of list sizes
    (format: specs/test_formats/shuffling/README.md)."""
    spec = phase0.get_spec(preset, device)
    rng = Random(2261)
    cases = []
    for size in (0, 1, 2, 3, 5, 16, 128):
        seed = bytes(rng.randrange(256) for _ in range(32))
        shuffled = [spec.get_shuffled_index(i, size, seed) for i in range(size)]
        cases.append({
            "seed": "0x" + seed.hex(),
            "count": size,
            "shuffled": shuffled,
        })
    return Suite(
        title="Shuffling",
        summary="Swap-or-not full permutations over various list sizes",
        config=preset,
        runner="shuffling",
        handler="core",
        test_cases=cases,
    )


# ---------------------------------------------------------------------------
# BLS (preset-independent curve vectors; emitted once under 'mainnet')
# ---------------------------------------------------------------------------

_BLS_MESSAGES = [b"\x00" * 32, b"\x56" * 32, b"\xab" * 32]
_BLS_DOMAINS = [0, 1, 1234]
_BLS_PRIVKEYS = [
    1,
    5566,
    0x00000000000000000000000000000000263dbd792f5b1be47ed85f8938c0f29586af0d3ac7b977f21c278fe1462040e3,
]


def _bls_sign_cases():
    out = []
    for sk in _BLS_PRIVKEYS:
        for msg in _BLS_MESSAGES:
            for dom in _BLS_DOMAINS:
                sig = curve.sign(msg, sk, dom)
                out.append({
                    "input": {"privkey": hex(sk), "message": "0x" + msg.hex(),
                              "domain": dom},
                    "output": "0x" + sig.hex(),
                })
    return out


def _bls_priv_to_pub_cases():
    return [{"input": hex(sk), "output": "0x" + curve.privtopub(sk).hex()}
            for sk in _BLS_PRIVKEYS]


def _bls_msg_hash_cases():
    """Uncompressed affine coordinates (reference
    test_generators/bls/main.py:88-98: case01_message_hash_G2_uncompressed)."""
    out = []
    for msg in _BLS_MESSAGES:
        for dom in _BLS_DOMAINS:
            x, y = curve.hash_to_g2(msg, dom)
            out.append({
                "input": {"message": "0x" + msg.hex(), "domain": dom},
                "output": [[hex(x.c0), hex(x.c1)], [hex(y.c0), hex(y.c1)]],
            })
    return out


def _bls_msg_hash_compressed_cases():
    """Compressed (z1, z2) halves (reference test_generators/bls/main.py
    :100-110 via :76-85: compress_G2 -> two 48-byte big-endian ints) —
    cross-client consumers expect BOTH forms as separate handlers."""
    out = []
    for msg in _BLS_MESSAGES:
        for dom in _BLS_DOMAINS:
            z = curve.compress_g2(curve.hash_to_g2(msg, dom))
            z1 = int.from_bytes(z[:48], "big")
            z2 = int.from_bytes(z[48:], "big")
            out.append({
                "input": {"message": "0x" + msg.hex(), "domain": dom},
                "output": ["0x" + z1.to_bytes(48, "big").hex(),
                           "0x" + z2.to_bytes(48, "big").hex()],
            })
    return out


def _bls_aggregate_sig_cases():
    out = []
    for msg in _BLS_MESSAGES:
        sigs = [curve.sign(msg, sk, 0) for sk in _BLS_PRIVKEYS]
        out.append({
            "input": ["0x" + s.hex() for s in sigs],
            "output": "0x" + curve.aggregate_signatures(sigs).hex(),
        })
    return out


def _bls_aggregate_pub_cases():
    pubs = [curve.privtopub(sk) for sk in _BLS_PRIVKEYS]
    return [{
        "input": ["0x" + p.hex() for p in pubs],
        "output": "0x" + curve.aggregate_pubkeys(pubs).hex(),
    }]


def bls_creators():
    handlers = {
        "sign_msg": _bls_sign_cases,
        "priv_to_pub": _bls_priv_to_pub_cases,
        "msg_hash_g2_uncompressed": _bls_msg_hash_cases,
        "msg_hash_g2_compressed": _bls_msg_hash_compressed_cases,
        "aggregate_sigs": _bls_aggregate_sig_cases,
        "aggregate_pubkeys": _bls_aggregate_pub_cases,
    }

    def make(handler, builder):
        def creator(preset: str, device="cuda"):
            if preset != "mainnet":
                return None  # curve math has no preset dependence; emit once
            return Suite(
                title=f"BLS {handler}",
                summary="BLS12-381 vectors from the framework's own curve oracle",
                config="mainnet",
                runner="bls",
                handler=handler,
                test_cases=builder(),
            )
        return creator

    return [make(h, b) for h, b in handlers.items()]


# ---------------------------------------------------------------------------
# ssz_static: randomized container vectors (needs the random factory)
# ---------------------------------------------------------------------------

_SSZ_MODES = [
    (RandomizationMode.RANDOM, 5),
    (RandomizationMode.ZERO, 1),
    (RandomizationMode.MAX, 1),
    (RandomizationMode.NIL, 1),
    (RandomizationMode.ONE, 1),
    (RandomizationMode.LENGTHY, 2),
]


def ssz_static_suite(preset: str, phase: str = "phase0", device="cuda") -> Suite:
    """Serialized bytes + roots for randomized instances of every container
    of the given phase's spec (format: specs/test_formats/ssz_static/
    core.md). The phase-1 family covers the field-appended
    Validator/BeaconState/BeaconBlockBody plus the custody and shard
    containers."""
    if phase == "phase0":
        spec = phase0.get_spec(preset, device)
    elif phase == "phase1":
        from ..models import phase1
        spec = phase1.get_spec(preset, device)
    else:
        raise KeyError(f"unknown phase {phase!r}")
    rng = Random(412)
    cases: List[dict] = []
    for name in sorted(spec.container_types.keys()):
        typ = getattr(spec, name)
        for mode, repeats in _SSZ_MODES:
            for _ in range(repeats):
                obj = get_random_ssz_object(rng, typ, mode, max_list_length=3)
                entry = {
                    "type_name": name,
                    "value": encode(obj, typ),
                    "serialized": "0x" + serialize(obj, typ).hex(),
                    "root": "0x" + hash_tree_root(obj, typ).hex(),
                }
                fields = typ.get_fields()
                if fields and fields[-1][0] == "signature":
                    entry["signing_root"] = "0x" + signing_root(obj, typ).hex()
                cases.append(entry)
    return Suite(
        title=f"SSZ static ({phase})",
        summary="Randomized serialization/Merkleization vectors per container",
        config=preset,
        runner="ssz_static",
        handler="core" if phase == "phase0" else f"core_{phase}",
        forks=[phase],
        test_cases=cases,
    )


def ssz_static_phase1_suite(preset: str, device="cuda") -> Suite:
    return ssz_static_suite(preset, phase="phase1", device=device)


# ---------------------------------------------------------------------------
# ssz_generic: atomic uint valid/invalid vectors
# (reference: test_generators/ssz_generic/uint_test_cases.py — random /
#  wrong-length / bounds / out-of-bounds cases over the 6 uint widths)
# ---------------------------------------------------------------------------

_UINT_BIT_SIZES = [8, 16, 32, 64, 128, 256]


def _uint_case(byte_len: int, *, value=None, serial=None, valid: bool,
               tags) -> dict:
    from ..fuzzing.sedes import UInt
    sedes = UInt(byte_len)
    case = {"type": f"uint{byte_len * 8}", "valid": valid,
            "tags": list(tags)}
    if valid:
        case["value"] = str(value)
        case["ssz"] = "0x" + sedes.encode(value).hex()
    else:
        case["ssz"] = "0x" + serial.hex()
    return case


def ssz_generic_suite(preset: str, device="cuda") -> Suite:
    """Atomic uint vectors — uniform random values, exact bounds, and
    invalid serializations (wrong length / out-of-range decimal), encoded
    by the independent sedes codec so the main SSZ stack can be diffed
    against it (format: specs/test_formats/ssz_generic/uint.md)."""
    if preset != "mainnet":
        return None  # wire format has no preset dependence; emit once
    rng = Random(1109)
    cases: List[dict] = []
    for bits in _UINT_BIT_SIZES:
        blen = bits // 8
        for _ in range(8):
            cases.append(_uint_case(
                blen, value=rng.randrange(2 ** bits), valid=True,
                tags=("atomic", "uint", "random")))
        for value, tag in ((0, "uint_lower_bound"),
                           (2 ** bits - 1, "uint_upper_bound")):
            cases.append(_uint_case(blen, value=value, valid=True,
                                    tags=("atomic", "uint", tag)))
        for length in sorted({0, blen // 2, blen - 1, blen + 1, blen * 2}):
            if length == blen:
                continue
            serial = bytes(rng.randrange(256) for _ in range(length))
            cases.append(_uint_case(blen, serial=serial, valid=False,
                                    tags=("atomic", "uint", "wrong_length")))
        # out-of-range values expressed as decimal (no valid serialization)
        for value, tag in ((2 ** bits, "uint_overflow"), (-1, "uint_underflow")):
            cases.append({"type": f"uint{bits}", "valid": False,
                          "value": str(value),
                          "tags": ["atomic", "uint", tag]})
    return Suite(
        title="SSZ generic uint",
        summary="Atomic uint valid/invalid wire vectors from the "
                "independent sedes codec",
        config="mainnet",
        runner="ssz_generic",
        handler="uint",
        test_cases=cases,
    )


# ---------------------------------------------------------------------------
# Registry of every family (the `make gen_yaml_tests` equivalent)
# ---------------------------------------------------------------------------

def all_creators():
    return (operations_creators() + epoch_processing_creators()
            + sanity_creators() + [shuffling_suite] + bls_creators()
            + [ssz_static_suite, ssz_static_phase1_suite, ssz_generic_suite])
