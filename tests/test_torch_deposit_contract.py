"""The port's deposit contract (consensus_specs_tpu_torch.deposit_contract)
== the JAX package's, case for case of tests/test_deposit_contract.py:
the same deposits through both contract models, leaves, roots, counts,
events and rejections equal byte for byte; the port's native C++ tree
(csrc/deposit_tree.cpp, built with g++ into the package's _build/) equal
to both, with no skip: a build failure fails these tests; and the port's
batch of leaves on a device (`deposit_data_roots`, here on the CPU
through the plain pair hash) equal to the host's.

The genesis threshold is the reference's module global, read at call
time: the tests monkeypatch it in both modules. The 65,536-deposit
genesis runs on the card only (chip_smoke.py, phase deposit)."""
from random import Random

import numpy as np
import pytest

from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.deposit_contract import contract as JC
from consensus_specs_tpu.models import phase0 as jphase0
from consensus_specs_tpu.testing import factories as jf
from consensus_specs_tpu.utils.merkle import get_merkle_root
from consensus_specs_tpu.utils.ssz.impl import hash_tree_root as j_htr
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.deposit_contract import DepositContract
from consensus_specs_tpu_torch.deposit_contract import contract as PC
from consensus_specs_tpu_torch.deposit_contract import native as PNATIVE
from consensus_specs_tpu_torch.models import phase0 as pphase0
from consensus_specs_tpu_torch.ops import _nvcc
from consensus_specs_tpu_torch.testing import factories as pf
from consensus_specs_tpu_torch.utils.ssz.impl import hash_tree_root as p_htr

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


def _args(i, amount=JC.FULL_DEPOSIT_GWEI):
    return dict(pubkey=bytes([i]) * 48, withdrawal_credentials=bytes([i + 1]) * 32,
                signature=bytes([i + 2]) * 96, value_gwei=amount)


def _leaf(C, a):
    return C.deposit_data_root(a["pubkey"], a["withdrawal_credentials"],
                               a["value_gwei"], a["signature"])


def test_constants_match():
    for name in ("TREE_DEPTH", "MIN_DEPOSIT_GWEI", "FULL_DEPOSIT_GWEI",
                 "CHAIN_START_FULL_DEPOSIT_THRESHOLD", "SECONDS_PER_DAY",
                 "MAX_DEPOSIT_COUNT"):
        assert getattr(PC, name) == getattr(JC, name), name


def test_leaf_matches_ssz_hash_tree_root():
    """The hand-rolled DepositData root == generic SSZ, in both packages;
    the device batch of the same leaves == the host's."""
    jspec, pspec = jphase0.get_spec("minimal"), pphase0.get_spec("minimal", device="cpu")
    for i in range(5):
        a = _args(i, amount=JC.MIN_DEPOSIT_GWEI + i)
        fields = dict(pubkey=a["pubkey"], withdrawal_credentials=a["withdrawal_credentials"],
                      amount=a["value_gwei"], signature=a["signature"])
        want = j_htr(jspec.DepositData(**fields), jspec.DepositData)
        assert _leaf(PC, a) == _leaf(JC, a) == want
        assert p_htr(pspec.DepositData(**fields), pspec.DepositData) == want
    rng = np.random.default_rng(11)
    n = 9
    pks = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    wcs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 96), dtype=np.uint8)
    vals = rng.integers(JC.MIN_DEPOSIT_GWEI, 2 ** 64, n, dtype=np.uint64)
    got = PC.deposit_data_roots(pks, wcs, vals, sigs, device="cpu")
    assert got.shape == (n, 32) and got.dtype == np.uint8
    for i in range(n):
        assert got[i].tobytes() == JC.deposit_data_root(
            pks[i].tobytes(), wcs[i].tobytes(), int(vals[i]), sigs[i].tobytes())


@pytest.mark.parametrize("count", [1, 2, 3, 7, 10])
def test_incremental_root_matches_full_tree(count):
    """O(log n) branch accumulation == the whole padded tree, both packages."""
    j, p = JC.DepositContract(), DepositContract()
    leaves = []
    for i in range(count):
        a = _args(i)
        assert p.deposit(**a) is None and j.deposit(**a) is None
        leaves.append(_leaf(PC, a))
        assert p.get_deposit_root() == j.get_deposit_root() == \
            get_merkle_root(leaves, pad_to=2 ** 32)
    assert p.get_deposit_count() == j.get_deposit_count() == count.to_bytes(8, "little")
    assert p.deposit_count == j.deposit_count == count


def test_contract_deposits_process_on_chain():
    """A deposit through the port's contract is accepted by the port's
    process_deposit against the contract's own root, with the state the
    reference's run reaches."""
    old = (JBLS.bls_active, PBLS.bls_active)
    JBLS.bls_active = PBLS.bls_active = False
    try:
        roots = []
        for C, spec, f, htr in (
                (JC, jphase0.get_spec("minimal"), jf, j_htr),
                (PC, pphase0.get_spec("minimal", device="cpu"), pf, p_htr)):
            state = f.seed_genesis_state(spec, spec.SLOTS_PER_EPOCH * 8)
            contract = C.DepositContract()
            state.deposit_index = 0
            newcomer = len(state.validator_registry)
            data = f.deposit_payload(spec, newcomer, C.FULL_DEPOSIT_GWEI)
            contract.deposit(pubkey=bytes(data.pubkey),
                             withdrawal_credentials=bytes(data.withdrawal_credentials),
                             signature=bytes(data.signature), value_gwei=int(data.amount))
            state.latest_eth1_data.deposit_root = contract.get_deposit_root()
            state.latest_eth1_data.deposit_count = contract.deposit_count
            tree = f.DepositTree(spec, [])
            deposit = spec.Deposit(proof=list(tree.proof_of(tree.append(data))), data=data)
            spec.process_deposit(state, deposit)
            assert len(state.validator_registry) == newcomer + 1
            assert state.validator_registry[newcomer].pubkey == data.pubkey
            roots.append((contract.get_deposit_root(),
                          htr(state, spec.BeaconState)))
        assert roots[1] == roots[0]
    finally:
        JBLS.bls_active, PBLS.bls_active = old


@pytest.mark.parametrize("field,value", [
    ("pubkey", b"\x00" * 47), ("withdrawal_credentials", b"\x00" * 31),
    ("signature", b"\x00" * 95), ("value_gwei", JC.MIN_DEPOSIT_GWEI - 1)])
def test_rejects_malformed_deposits(field, value):
    for C in (JC, PC):
        contract = C.DepositContract()
        with pytest.raises(AssertionError):
            contract.deposit(**{**_args(0), field: value})
        assert contract.deposit_count == 0 and contract.logs == []


def test_eth2genesis_fires_at_threshold(monkeypatch):
    monkeypatch.setattr(JC, "CHAIN_START_FULL_DEPOSIT_THRESHOLD", 3)
    monkeypatch.setattr(PC, "CHAIN_START_FULL_DEPOSIT_THRESHOLD", 3)
    got = []
    for C in (JC, PC):
        contract = C.DepositContract()
        events = [contract.deposit(**_args(i), timestamp=1_700_000_123) for i in range(3)]
        assert events[:2] == [None, None] and contract.chain_started
        g = events[2]
        assert g.deposit_root == contract.get_deposit_root()
        assert g.deposit_count == (3).to_bytes(8, "little")
        t = int.from_bytes(g.time, "little")
        assert t % 86400 == 0 and t > 1_700_000_123
        got.append((g.deposit_root, g.deposit_count, g.time, type(contract.logs[-1]).__name__))
    assert got[1] == got[0]


def test_partial_deposits_do_not_count_toward_genesis(monkeypatch):
    monkeypatch.setattr(JC, "CHAIN_START_FULL_DEPOSIT_THRESHOLD", 2)
    monkeypatch.setattr(PC, "CHAIN_START_FULL_DEPOSIT_THRESHOLD", 2)
    for C in (JC, PC):
        contract = C.DepositContract()
        assert contract.deposit(**_args(0, amount=C.MIN_DEPOSIT_GWEI)) is None
        assert contract.deposit(**_args(1, amount=C.MIN_DEPOSIT_GWEI)) is None
        assert not contract.chain_started
        assert contract.deposit(**_args(2)) is None
        assert contract.deposit(**_args(3)) is not None
        assert contract.chain_started and contract.full_deposit_count == 2


def test_deposit_events_logged():
    logs = []
    for C in (JC, PC):
        contract = C.DepositContract()
        contract.deposit(**_args(5))
        contract.deposit(**_args(6, amount=C.MIN_DEPOSIT_GWEI))
        logs.append([vars(e) for e in contract.logs])
    assert logs[1] == logs[0]
    first = logs[1][0]
    assert first["pubkey"] == bytes([5]) * 48
    assert first["merkle_tree_index"] == (0).to_bytes(8, "little")
    assert first["amount"] == PC.FULL_DEPOSIT_GWEI.to_bytes(8, "little")


# ---------------------------------------------------------------------------
# Native (C++) accumulator: never skipped in the port
# ---------------------------------------------------------------------------

def test_native_builds_into_the_package():
    assert PNATIVE.available() is True
    lib = PNATIVE.library_path()
    assert lib.parent == _nvcc.BUILD and lib.is_file()
    assert lib.name.startswith("deposit_tree-") and PNATIVE.SOURCE.parent == _nvcc.CSRC
    assert "deposit_tree" not in _nvcc.SOURCES


def test_native_tree_matches_python_model():
    rng = Random(77)
    py, ref = DepositContract(), JC.DepositContract()
    cc = PNATIVE.NativeDepositTree()
    assert cc.get_deposit_root() == py.get_deposit_root() == ref.get_deposit_root()
    for i in range(33):   # crosses several subtree-completion boundaries
        pk = bytes(rng.randrange(256) for _ in range(48))
        wc = bytes(rng.randrange(256) for _ in range(32))
        sig = bytes(rng.randrange(256) for _ in range(96))
        amount = rng.choice([1_000_000_000, 32_000_000_000, 5_555_555_555])
        py.deposit(pk, wc, sig, amount)
        cc.deposit(pk, wc, sig, amount)
        assert cc.deposit_count == py.deposit_count == i + 1
        ref.deposit(pk, wc, sig, amount)
        assert cc.get_deposit_root() == py.get_deposit_root() == ref.get_deposit_root(), i


def test_native_batch_matches_sequential():
    rng = np.random.default_rng(9)
    n = 20
    pks = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    wcs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 96), dtype=np.uint8)
    vals = np.full(n, 32_000_000_000, np.uint64)
    a, b = PNATIVE.NativeDepositTree(), PNATIVE.NativeDepositTree()
    a.deposit_batch(pks, wcs, sigs, vals)
    for i in range(n):
        b.deposit(pks[i].tobytes(), wcs[i].tobytes(), sigs[i].tobytes(), int(vals[i]))
    assert a.get_deposit_root() == b.get_deposit_root()
    assert a.deposit_count == n
    with pytest.raises(ValueError):          # never reads past a short column
        a.deposit_batch(pks, wcs[:-1], sigs, vals)
    assert a.deposit_count == n
    py = JC.DepositContract()
    for i in range(n):
        py.deposit(pks[i].tobytes(), wcs[i].tobytes(), sigs[i].tobytes(), int(vals[i]))
    assert a.get_deposit_root() == py.get_deposit_root()
    # the device leaves of the same batch, folded on the device, give the root
    from consensus_specs_tpu_torch.ops.sha256 import merkle_root_from_leaves_device
    from consensus_specs_tpu_torch.utils.hash import sha256, zerohashes
    leaves = PC.deposit_data_roots(pks, wcs, vals, sigs, device="cpu")
    node = merkle_root_from_leaves_device([r.tobytes() for r in leaves], 32, device="cpu")
    for depth in range(5, PC.TREE_DEPTH):
        node = sha256(node + zerohashes[depth])
    assert node == py.get_deposit_root()


def test_native_rejects_below_minimum():
    cc = PNATIVE.NativeDepositTree()
    with pytest.raises(AssertionError):
        cc.deposit(b"\x01" * 48, b"\x02" * 32, b"\x03" * 96, 999)
    with pytest.raises(ValueError):          # never reads past a short buffer
        cc.deposit(b"\x01" * 47, b"\x02" * 32, b"\x03" * 96, 32_000_000_000)
    assert cc.deposit_count == 0


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output; nothing is
    left in the build directory and nothing reads False."""
    bad = tmp_path / "deposit_tree.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(PNATIVE, "SOURCE", bad)
    monkeypatch.setattr(PNATIVE, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(PNATIVE, "_lib", None)
    with pytest.raises(_nvcc.KernelCompileError, match="g\\+\\+ failed"):
        PNATIVE.NativeDepositTree()
    assert list((tmp_path / "_build").iterdir()) == []
