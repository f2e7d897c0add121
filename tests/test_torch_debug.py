"""The port's debug codecs, random-value factory, sedes codec and full-tree
Merkle helpers (consensus_specs_tpu_torch: debug/, fuzzing/, utils/merkle.py)
on the CPU.

Twins of the JAX package's tests/test_debug_codecs.py,
tests/test_random_value.py and tests/test_fuzzing_decoder.py, run against
the port; then differential checks: the same seed gives the same random
objects, encodings, sedes bytes and Merkle trees in both packages."""
import random
import zlib
from random import Random

import numpy as np
import pytest

from consensus_specs_tpu.debug import encode as JE
from consensus_specs_tpu.debug import random_value as JR
from consensus_specs_tpu.fuzzing import translate_type as j_translate_type
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.utils import merkle as JM
from consensus_specs_tpu.utils.ssz import impl as JI
from consensus_specs_tpu_torch.debug.decode import decode
from consensus_specs_tpu_torch.debug.encode import encode, encode_with_signing_root
from consensus_specs_tpu_torch.debug.random_value import (
    RandomizationMode, get_mode_by_name, get_random_ssz_object)
from consensus_specs_tpu_torch.fuzzing import translate_type, translate_value
from consensus_specs_tpu_torch.fuzzing.sedes import Boolean, HomogeneousList, UInt
from consensus_specs_tpu_torch.models import phase0
from consensus_specs_tpu_torch.utils import merkle as PM
from consensus_specs_tpu_torch.utils.ssz.impl import (
    deserialize, hash_tree_root, serialize)
from consensus_specs_tpu_torch.utils.ssz.typing import (
    Bytes32, Bytes96, Container, List, Vector, uint8, uint16, uint64, uint256)

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

SPEC = phase0.get_spec("minimal", device="cpu")
J_SPEC = JP.get_spec("minimal")
CONTAINER_NAMES = sorted(SPEC.container_types.keys())


class Inner(Container):
    a: uint64
    b: Bytes32


class Outer(Container):
    x: uint8
    items: List[uint64]
    fixed: Vector[uint64, 3]
    inner: Inner
    sig: Bytes96
    raw: List[uint8]


# ---------------------------------------------------------------------------
# tests/test_debug_codecs.py, against the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [RandomizationMode.RANDOM,
                                  RandomizationMode.ZERO,
                                  RandomizationMode.MAX])
@pytest.mark.parametrize("seed", [0, 7])
def test_encode_decode_round_trip_synthetic(mode, seed):
    rng = random.Random(seed)
    obj = get_random_ssz_object(rng, Outer, mode=mode, max_list_length=5)
    back = decode(encode(obj, Outer), Outer)
    assert serialize(back, Outer) == serialize(obj, Outer)


def test_encode_decode_round_trip_spec_containers():
    rng = random.Random(42)
    for name in ("Validator", "AttestationData", "BeaconBlockHeader",
                 "Crosslink", "Deposit", "Checkpoint"):
        typ = getattr(SPEC, name, None)
        if typ is None:
            continue
        obj = get_random_ssz_object(rng, typ, max_list_length=4)
        back = decode(encode(obj, typ), typ)
        assert serialize(back, typ) == serialize(obj, typ), name


def test_decode_checks_embedded_roots():
    """encode(..., include_hash_tree_roots=True) output decodes, and a
    tampered field root is refused."""
    rng = random.Random(3)
    typ = SPEC.BeaconBlockHeader
    obj = get_random_ssz_object(rng, typ)
    doc = encode(obj, typ, include_hash_tree_roots=True)
    assert serialize(decode(doc, typ), typ) == serialize(obj, typ)
    doc["slot_hash_tree_root"] = "0x" + "00" * 32
    with pytest.raises(AssertionError):
        decode(doc, typ)


# ---------------------------------------------------------------------------
# tests/test_random_value.py, against the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(RandomizationMode))
@pytest.mark.parametrize("name", CONTAINER_NAMES)
def test_container_roundtrip(name, mode):
    typ = getattr(SPEC, name)
    rng = Random(zlib.crc32(name.encode()) ^ mode.value)
    obj = get_random_ssz_object(rng, typ, mode)
    data = serialize(obj, typ)
    back = deserialize(data, typ)
    assert serialize(back, typ) == data
    assert hash_tree_root(back, typ) == hash_tree_root(obj, typ)


@pytest.mark.parametrize("typ", [
    uint8, uint16, uint64, uint256, bool, Bytes32,
    List[uint64], Vector[uint64, 4], Vector[Bytes32, 3],
])
@pytest.mark.parametrize("mode_name", ["random", "zero", "max", "nil", "one", "lengthy"])
def test_primitive_roundtrip(typ, mode_name):
    mode = get_mode_by_name(mode_name)
    rng = Random(42)
    obj = get_random_ssz_object(rng, typ, mode)
    data = serialize(obj, typ)
    back = deserialize(data, typ)
    assert serialize(back, typ) == data


def test_modes_shape_lists():
    rng = Random(7)
    assert get_random_ssz_object(rng, List[uint64], RandomizationMode.NIL) == []
    one = get_random_ssz_object(rng, List[uint64], RandomizationMode.ONE)
    assert len(one) == 1
    lengthy = get_random_ssz_object(rng, List[uint64], RandomizationMode.LENGTHY)
    assert 50 <= len(lengthy) <= 100


def test_zero_mode_is_zero_value():
    rng = Random(1)
    obj = get_random_ssz_object(rng, SPEC.Validator, RandomizationMode.ZERO)
    assert obj == SPEC.Validator()


def test_max_mode_uints_saturate():
    rng = Random(1)
    assert get_random_ssz_object(rng, uint16, RandomizationMode.MAX) == 0xFFFF


def test_chaos_still_roundtrips():
    rng = Random(99)
    for _ in range(5):
        obj = get_random_ssz_object(rng, SPEC.BeaconBlock, RandomizationMode.RANDOM,
                                    chaos=True)
        data = serialize(obj, SPEC.BeaconBlock)
        assert serialize(deserialize(data, SPEC.BeaconBlock), SPEC.BeaconBlock) == data


# ---------------------------------------------------------------------------
# tests/test_fuzzing_decoder.py, against the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONTAINER_NAMES)
def test_cross_decode_every_container(name):
    typ = getattr(SPEC, name)
    sedes = translate_type(typ)
    rng = Random(zlib.crc32(name.encode()))
    for mode in (RandomizationMode.RANDOM, RandomizationMode.NIL,
                 RandomizationMode.LENGTHY):
        obj = get_random_ssz_object(rng, typ, mode, max_list_length=4)
        wire = serialize(obj, typ)
        decoded = sedes.decode(wire)
        back = translate_value(decoded, typ)
        assert serialize(back, typ) == wire
        assert hash_tree_root(back, typ) == hash_tree_root(obj, typ)
        assert sedes.encode(decoded) == wire


def test_random_beacon_state_roundtrip():
    typ = SPEC.BeaconState
    sedes = translate_type(typ)
    rng = Random(99)
    obj = get_random_ssz_object(rng, typ, RandomizationMode.RANDOM,
                                max_list_length=3)
    wire = serialize(obj, typ)
    back = translate_value(sedes.decode(wire), typ)
    assert hash_tree_root(back, typ) == hash_tree_root(obj, typ)


@pytest.mark.parametrize("mutilate", [
    lambda b: b[:-1],                            # truncated tail
    lambda b: b[: len(b) // 2],                  # half the message
    # absurd body offset (BeaconBlock's only variable field, at byte 72
    # after slot/parent_root/state_root)
    lambda b: b[:72] + b"\xff\xff\xff\xff" + b[76:],
])
def test_malformed_wire_rejected(mutilate):
    typ = SPEC.BeaconBlock
    sedes = translate_type(typ)
    rng = Random(3)
    obj = get_random_ssz_object(rng, typ, RandomizationMode.RANDOM,
                                max_list_length=2)
    wire = mutilate(serialize(obj, typ))
    with pytest.raises(ValueError):
        sedes.decode(wire)


def test_uint_bounds_and_bool_strictness():
    assert UInt(8).decode(b"\xff" * 8) == 2 ** 64 - 1
    with pytest.raises(ValueError):
        UInt(8).decode(b"\x00" * 7)
    with pytest.raises(ValueError):
        Boolean().decode(b"\x02")


def test_hostile_first_offset_rejected_cheaply():
    lst = HomogeneousList(UInt(8))
    with pytest.raises(ValueError):
        lst.decode(b"\xfc\xff\xff\xff")


# ---------------------------------------------------------------------------
# Differential: the port's objects and bytes == the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(RandomizationMode))
@pytest.mark.parametrize("name", CONTAINER_NAMES)
def test_random_objects_match_the_jax_package(name, mode):
    """One seed, one mode: the two factories draw the same object (same
    serialization, root and encoding; the sedes codecs agree on the bytes)."""
    seed = zlib.crc32(name.encode()) ^ mode.value
    typ, j_typ = getattr(SPEC, name), getattr(J_SPEC, name)
    obj = get_random_ssz_object(Random(seed), typ, mode, max_list_length=3)
    j_obj = JR.get_random_ssz_object(Random(seed), j_typ, JR.RandomizationMode(mode.value),
                                     max_list_length=3)
    wire = serialize(obj, typ)
    assert wire == JI.serialize(j_obj, j_typ)
    assert hash_tree_root(obj, typ) == JI.hash_tree_root(j_obj, j_typ)
    assert encode(obj, typ, include_hash_tree_roots=True) == JE.encode(
        j_obj, j_typ, include_hash_tree_roots=True)
    decoded = translate_type(typ).decode(wire)
    assert decoded == j_translate_type(j_typ).decode(wire)
    assert translate_type(typ).encode(decoded) == wire
    if typ.get_fields()[-1][0] == "signature":
        assert encode_with_signing_root(obj) == JE.encode_with_signing_root(j_obj)


@pytest.mark.parametrize("n,depth", [(0, 0), (1, 0), (1, 3), (5, 3), (8, 3), (13, 5),
                                     (3, 32)])
def test_merkle_tree_and_proofs_match_the_jax_package(n, depth):
    rng = np.random.default_rng(n * 100 + depth)
    leaves = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
    tree = PM.calc_merkle_tree_from_leaves(leaves, depth)
    assert tree == JM.calc_merkle_tree_from_leaves(leaves, depth)
    for i in range(n):
        proof = PM.get_merkle_proof(tree, item_index=i)
        assert proof == JM.get_merkle_proof(tree, item_index=i)
        assert PM.verify_merkle_branch(leaves[i], proof, depth, i, tree[-1][0])
    pad_to = max(1, 1 << depth) if depth < 32 else max(n, 1)
    if n <= pad_to:
        assert PM.get_merkle_root(leaves, pad_to) == JM.get_merkle_root(leaves, pad_to)


def test_merkle_root_of_no_leaves_and_overfull():
    assert PM.get_merkle_root([], 8) == JM.get_merkle_root([], 8)
    with pytest.raises(AssertionError):
        PM.get_merkle_root([b"\x00" * 32] * 3, 2)
