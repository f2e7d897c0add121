"""Sharded == single device, bit for bit, in the port
(consensus_specs_tpu_torch/parallel/), scenario for scenario of
tests/test_multichip.py: the epoch program over [V] columns sharded on
ServingMesh(["cpu"] * 8) against the port's single-device program and the
JAX package's (seeds 0 and 3, with exits in flight, ejections ranked
across shards, slashings due), a V that does not divide the mesh (inert
padding, a chained second boundary), outputs that stay as shards on their
devices, the registry and balances roots through the mesh's leaf builders
and sharded forests, the sharded incremental forest (build, scattered
update, append across the padded power of two), the leaf builders'
masking and placement, the hierarchical grid, and the grouped pairing
with its groups split over the shards (one real CPU pairing on the
single route and one a shard on a 2-shard mesh; the other cases on the
stand-in pairing of tests/test_torch_streaming.py). The exchange's
collectives are held against numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.models.phase0 import epoch_soa as JE
from consensus_specs_tpu.ops import bls_jax as BJ
from consensus_specs_tpu.parallel import sharding as JS
from consensus_specs_tpu.utils.ssz import bulk as JB
from consensus_specs_tpu.utils.ssz import incremental as JI
from consensus_specs_tpu_torch import telemetry as PT
from consensus_specs_tpu_torch.convert import columns_from_numpy, columns_to_numpy
from consensus_specs_tpu_torch.models.phase0 import epoch_soa as TE
from consensus_specs_tpu_torch.ops import bls_torch as BT
from consensus_specs_tpu_torch.parallel import Replicated, ShardExchange, Sharded
from consensus_specs_tpu_torch.parallel import sharding as PS
from consensus_specs_tpu_torch.utils.ssz import bulk as PB
from consensus_specs_tpu_torch.utils.ssz import impl as PSSZ
from consensus_specs_tpu_torch.utils.ssz import incremental as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)
from test_torch_epoch import _hazards

N_DEV = 8
CPU8 = ["cpu"] * N_DEV


@pytest.fixture(scope="module")
def cfg():
    return TE.EpochConfig.from_preset("minimal")


@pytest.fixture
def mesh():
    return PS.ServingMesh(CPU8)


def _state(cfg, V, seed, hazards=True):
    rng = np.random.default_rng(seed)
    cols, scal, inp = TE.synthetic_epoch_state(
        cfg, V, rng, random_eligibility=True, random_slashed_balances=True)
    if hazards:
        cols = _hazards(cfg, cols, scal, rng)
    return cols, scal, inp


def _jax(cfg, cols, scal, inp):
    out = JE.epoch_transition_device(JE.EpochConfig(*cfg), JE.ValidatorColumns(*cols),
                                     JE.EpochScalars(*scal), JE.EpochInputs(*inp))
    return tuple(type(nt)(*[np.asarray(x) for x in nt]) for nt in out)


def _single(cfg, cols, scal, inp):
    return columns_to_numpy(*TE.epoch_transition_device(
        cfg, *columns_from_numpy(cols, scal, inp, "cpu")))


def _sharded(cfg, mesh, cols, scal, inp, V):
    """-> (the mesh's outputs, their numpy form cut to the [V] prefix)."""
    c, s, i = columns_from_numpy(cols, scal, inp, "cpu")
    vp = mesh.pad_rows(V)
    c = TE.pad_validator_columns(c, vp, cfg.FAR_FUTURE_EPOCH)
    i = TE.pad_epoch_inputs(i, vp)
    out = mesh.epoch_transition(cfg, *PS.shard_epoch_state(mesh, c, s, i))
    np_out = columns_to_numpy(*out)
    return out, (type(np_out[0])(*[x[:V] for x in np_out[0]]),) + np_out[1:]


def _same(a, b):
    for x, y in zip(a, b):
        for f in type(x)._fields:
            g, w = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all(), f


@pytest.mark.parametrize("seed", [0, 3])
def test_epoch_transition_sharded_equals_single(cfg, mesh, seed):
    V = 64 * N_DEV
    cols, scal, inp = _state(cfg, V, seed)
    _, got = _sharded(cfg, mesh, cols, scal, inp, V)
    single = _single(cfg, cols, scal, inp)
    _same(got, single)
    _same(single, _jax(cfg, cols, scal, inp))
    # the state exercises every cross-shard step: ejections ranked across
    # shards, activations dequeued by the global sort, proposers elsewhere
    ejected = (single[0].exit_epoch != cols.exit_epoch)
    assert len({int(k) // 64 for k in np.nonzero(ejected)[0]}) > 1
    assert (single[0].activation_epoch != cols.activation_epoch).any()
    assert (inp.att_proposer // 64 != np.arange(V) // 64).any()


def test_serving_mesh_epoch_padded_equals_single(cfg, mesh):
    """V not divisible by the mesh (5 inert rows): the [V] prefix of the
    padded sharded program equals the single-device program, and the
    padding stays inert through a chained second boundary."""
    V = 64 * N_DEV + 3
    cols, scal, inp = _state(cfg, V, 17)
    out, got = _sharded(cfg, mesh, cols, scal, inp, V)
    _same(got, _single(cfg, cols, scal, inp))
    _same(got, _jax(cfg, cols, scal, inp))
    assert out[0].balance.rows == mesh.pad_rows(V) == 520
    pad = columns_to_numpy(out[0])[0]
    assert (pad.balance[V:] == 0).all() and (pad.activation_epoch[V:] == np.uint64(cfg.FAR_FUTURE_EPOCH)).all()
    # chain: the same shards into the next boundary
    spe = cfg.SLOTS_PER_EPOCH
    t_inp = columns_from_numpy(None, None, inp, "cpu")[2]
    out2 = mesh.epoch_transition(cfg, out[0], out[1]._replace(slot=out[1].slot + spe),
                                 TE.pad_epoch_inputs(t_inp, mesh.pad_rows(V)))
    single1 = TE.epoch_transition_device(cfg, *columns_from_numpy(cols, scal, inp, "cpu"))
    single2 = TE.epoch_transition_device(
        cfg, single1[0], single1[1]._replace(slot=single1[1].slot + spe), t_inp)
    got2 = columns_to_numpy(*out2)
    _same((type(got2[0])(*[x[:V] for x in got2[0]]),) + got2[1:],
          columns_to_numpy(*single2))
    assert (got2[0].balance[V:] == 0).all()


def test_sharded_output_stays_sharded(cfg, mesh):
    """The boundary's [Vp] columns come back as the same shards on their
    devices, written in place, never gathered; scalars and report on
    home."""
    V = 64 * N_DEV
    cols, scal, inp = _state(cfg, V, 1, hazards=False)
    c, s, i = PS.shard_epoch_state(mesh, *columns_from_numpy(cols, scal, inp, "cpu"))
    ptrs = [[t.data_ptr() for t in col.shards] for col in c]
    out_cols, out_scal, out_rep = mesh.epoch_transition(cfg, c, s, i)
    assert out_cols is c
    for col, before in zip(out_cols, ptrs):
        assert isinstance(col, Sharded) and col.devices == mesh.devices
        assert [t.data_ptr() for t in col.shards] == before
        assert [tuple(t.shape) for t in col.shards] == [(64,)] * N_DEV
    assert out_scal.slot.device == mesh.home and out_rep.finalized_fired.device == mesh.home


def test_bulk_merkleizer_sharded_equals_single(mesh):
    """The registry and balances roots from sharded columns (the mesh's
    leaf builders and sharded forests) == the single-device bulk roots ==
    the JAX package's."""
    rng = np.random.default_rng(11)
    V = 256 * N_DEV
    cols = (rng.integers(0, 256, (V, 48), dtype=np.uint8),
            rng.integers(0, 256, (V, 32), dtype=np.uint8),
            np.zeros(V, np.uint64), np.zeros(V, np.uint64),
            np.zeros(V, np.uint64), np.zeros(V, np.uint64),
            rng.random(V) < 0.01,
            np.full(V, 32_000_000_000, np.uint64),
            rng.integers(31_000_000_000, 33_000_000_000, V).astype(np.uint64))
    t = [torch.from_numpy(c.view(np.int64) if c.dtype == np.uint64 else c) for c in cols]
    single = PB.registry_and_balances_roots_device(*t)
    sh = PS.shard_leading_axis(mesh, tuple(t))
    reg = PI.ShardedIncrementalMerkleTree(
        mesh.registry_forest_leaves(*sh[:8], v_count=V), mesh, logical_n=V)
    bal = PI.ShardedIncrementalMerkleTree(
        mesh.balances_forest_chunks(sh[8], V), mesh, logical_n=V // 4)
    sharded = tuple(PSSZ.mix_in_length(tree.root(), V) for tree in (reg, bal))
    assert sharded == single == JB.registry_and_balances_roots_device(*cols)


def test_sharded_forest_matches_single(mesh):
    """Build, scattered update and append-grow across 128 (and the shard
    boundaries), against the port's and the JAX package's single-device
    trees: same roots, same lanes per level, levels materialized to the
    pow2 capacity, sharded below the cap; per-shard launches counted."""
    rng = np.random.default_rng(21)
    V = 100
    leaves = rng.integers(0, 2 ** 32, (V, 8), dtype=np.uint32)
    words = lambda a: torch.from_numpy(a.view(np.int32).copy())  # noqa: E731
    single = PI.IncrementalMerkleTree(words(leaves))
    jtree = JI.IncrementalMerkleTree(leaves.copy())
    PT.reset()
    shard = PI.ShardedIncrementalMerkleTree(words(leaves), mesh)
    assert shard.root() == single.root() == jtree.root()
    assert (shard.n, shard.depth) == (single.n, single.depth) == (V, 7)
    assert isinstance(shard.levels[0], Sharded) and shard.levels[0].rows == 128
    assert shard.levels[0].devices == mesh.devices
    assert isinstance(shard.levels[-1], Replicated)
    # levels 0..4 (128..8 rows) sharded, one launch a shard for 0..3
    assert [type(lv).__name__ for lv in shard.levels] == ["Sharded"] * 5 + ["Replicated"] * 3
    assert PT.counter("merkle.forest.launches").value == 4 * N_DEV + 3

    idx = np.array([0, 5, 63, 99])
    rows = rng.integers(0, 2 ** 32, (4, 8), dtype=np.uint32)
    for tree in (single, shard):
        tree.update(idx, words(rows))
    jtree.update(idx.astype(np.int32), rows.copy())
    assert shard.root() == single.root() == jtree.root()
    assert shard.last_pairs_per_level == single.last_pairs_per_level == jtree.last_pairs_per_level
    assert sum(shard.last_pairs_per_level) <= 2 * 4 * shard.depth

    rows2 = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    for tree in (single, shard):
        tree.append(words(rows2))
    jtree.append(rows2.copy())
    assert shard.root() == single.root() == jtree.root()
    assert shard.n == single.n == 140 and shard.levels[0].rows == 256
    assert isinstance(shard.levels[0], Sharded)
    assert [tuple(s.shape) for s in shard.levels[0].shards] == [(32, 8)] * N_DEV
    assert shard.builds == single.builds == 1


def test_serving_mesh_forest_leaf_builders_match_oracle(mesh):
    """registry_forest_leaves / balances_forest_chunks: inert padding rows
    masked to the SSZ virtual zero rows, real rows equal to the
    single-device builders (and the JAX package's), the rows laid out
    again at the pow2 of the LOGICAL count; a registry grown inside the
    same padding is a new v_count on the same shards."""
    rng = np.random.default_rng(29)
    V, vp = 100, mesh.pad_rows(100)
    pk = rng.integers(0, 256, (vp, 48), dtype=np.uint8)
    wc = rng.integers(0, 256, (vp, 32), dtype=np.uint8)
    epochs = [rng.integers(0, 50, vp).astype(np.uint64) for _ in range(4)]
    slashed = rng.random(vp) < 0.1
    eff = rng.integers(1, 2 ** 35, vp).astype(np.uint64)
    bal = np.where(np.arange(vp) < V, rng.integers(1, 2 ** 35, vp), 0).astype(np.uint64)
    host = [pk, wc, *epochs, slashed, eff]
    t = lambda a: torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)  # noqa: E731
    args = [mesh.shard(t(a)) for a in host]
    for v in (V, 97):
        leaves = mesh.registry_forest_leaves(*args, v_count=v)
        assert isinstance(leaves, Sharded) and leaves.rows == 128
        assert [tuple(s.shape) for s in leaves.shards] == [(16, 8)] * N_DEV
        got = torch.cat(leaves.shards).numpy()
        want = PB.registry_leaf_words_device(*[t(a[:v]) for a in host]).numpy()
        assert (got[:v] == want).all() and not got[v:].any()
    jwant = np.asarray(JB.registry_leaf_words_device(*[a[:V] for a in host]))
    assert (torch.cat(mesh.registry_forest_leaves(*args, v_count=V).shards).numpy()[:V]
            == jwant.view(np.int32)).all()

    chunks = mesh.balances_forest_chunks(mesh.shard(t(bal)), V)
    assert isinstance(chunks, Sharded) and chunks.rows == 32
    want_c = PB.balances_chunk_words_device(t(bal[:V])).numpy()
    got_c = torch.cat(chunks.shards).numpy()
    assert (got_c[:want_c.shape[0]] == want_c).all() and not got_c[want_c.shape[0]:].any()
    assert (want_c == np.asarray(JB.balances_chunk_words_device(bal[:V])).view(np.int32)).all()
    # below the mesh size the level-0 rows replicate (the reference's cap rule)
    small = mesh.registry_forest_leaves(*args, v_count=3)
    assert isinstance(small, Replicated) and small.rows == 4
    assert isinstance(mesh.balances_forest_chunks(mesh.shard(t(bal)), 3), Replicated)


def test_hierarchical_mesh_epoch_equals_single(cfg):
    """8 devices arranged as 2 hosts x 4: the epoch program over the
    flattened (host, v) shards equals the single-device program."""
    grid = PS.hierarchical_mesh(CPU8, hosts=2)
    assert grid.shape == (2, 4)
    V = 64 * N_DEV
    cols, scal, inp = _state(cfg, V, 9, hazards=False)
    c, s, i = columns_from_numpy(cols, scal, inp, "cpu")
    c_s, s_s = PS.shard_hierarchical(grid, c), PS.shard_hierarchical(grid, s)
    i_s = PS.shard_hierarchical(grid, i)
    assert isinstance(s_s.slot, Replicated) and isinstance(i_s.prev_src, Sharded)
    out = PS.ServingMesh(grid.flat).epoch_transition(cfg, c_s, s_s, i_s)
    _same(columns_to_numpy(*out), _single(cfg, cols, scal, inp))


# ---------------------------------------------------------------------------
# The attestation axis: grouped pairing verdicts split over the shards
# ---------------------------------------------------------------------------

def test_grouped_pairing_sharded_equals_single():
    """Real pairings: one good group and one with a swapped key, single
    route (one call) against a 2-shard mesh (one call a shard)."""
    g1, g2 = BT.stage_example_groups(2)
    g1[1, 1] = g1[1, 2]                      # the wrong pubkey in group 1
    single = BT.grouped_pairing_check(torch.from_numpy(g1), torch.from_numpy(g2))
    sharded = PS.ServingMesh(["cpu"] * 2).grouped_pairing_check(g1, g2)
    assert single.tolist() == sharded.tolist() == [True, False]


@pytest.fixture
def stand_in(monkeypatch):
    """The cheap stand-in pairing of tests/test_torch_streaming.py on both
    packages: a group passes iff its first limb is not a multiple of 3."""
    monkeypatch.setattr(BJ, "grouped_pairing_check",
                        lambda g1, g2: jnp.asarray(np.asarray(g1)[:, 0, 0, 0] % 3 != 0))
    monkeypatch.setattr(BT, "grouped_pairing_check", lambda g1, g2: g1[:, 0, 0, 0] % 3 != 0)


def test_grouped_pairing_sharded_bookkeeping(stand_in, mesh):
    """Eight shards of two groups: verdicts joined in group order, each
    shard's check run on its own shard's groups only, a failing group
    failing at its index; a group count that does not divide the mesh is
    refused."""
    keys = np.array([1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17])
    g1 = np.broadcast_to(keys[:, None, None, None], (16, 2, 2, 3)).astype(np.int64).copy()
    g2 = np.zeros((16, 2, 2, 2, 3), np.int64)
    seen = []
    real = BT.grouped_pairing_check
    BT.grouped_pairing_check = lambda a, b: (seen.append(a[:, 0, 0, 0].tolist()), real(a, b))[1]
    try:
        got = mesh.grouped_pairing_check(g1, g2)
    finally:
        BT.grouped_pairing_check = real
    want = BT.grouped_pairing_check(torch.from_numpy(g1), torch.from_numpy(g2))
    jmesh = JS.validator_mesh(n=N_DEV)
    jg1, jg2 = JS.shard_leading_axis(jmesh, (jnp.asarray(g1), jnp.asarray(g2)))
    jwant = np.asarray(BJ.grouped_pairing_check(jg1, jg2))
    assert got.tolist() == want.tolist() == jwant.tolist() == list(keys % 3 != 0)
    assert seen == [keys[2 * i:2 * i + 2].tolist() for i in range(N_DEV)]
    with pytest.raises(ValueError, match="pad_leading_pow2"):
        mesh.grouped_pairing_check(g1[:12], g2[:12])


# ---------------------------------------------------------------------------
# The exchange's collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_exchange_collectives_match_numpy(n):
    rng = np.random.default_rng(5 + n)
    ex = ShardExchange(["cpu"] * n)
    ex.fence = True           # clocked; no copies between devices on one device
    rows = [3, 5, 2, 6][:n] if n > 1 else [16]
    total = sum(rows)
    parts = [torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, 3, dtype=np.int64))
             for _ in range(n)]
    want_sum = np.sum([p.numpy() for p in parts], axis=0, dtype=np.int64)
    assert all((s.numpy() == want_sum).all() for s in ex.sum(parts))
    as_u64 = [p.numpy().view(np.uint64) for p in parts]
    want_max = np.max(as_u64, axis=0)
    assert all((m.numpy().view(np.uint64) == want_max).all() for m in ex.umax(parts))
    for k, (tot, before) in enumerate(ex.prefix(parts)):
        assert (tot.numpy() == want_sum).all()
        assert (before.numpy() == np.sum([p.numpy() for p in parts[:k]], axis=0,
                                         dtype=np.int64)).all()
    idx = [torch.from_numpy(rng.integers(0, total, r).astype(np.int32)) for r in rows]
    vals = [torch.from_numpy(rng.integers(0, 100, r)) for r in rows]
    got = torch.cat(ex.scatter_add(list(zip(idx, vals, rows)))).numpy()
    want = np.zeros(total, np.int64)
    np.add.at(want, torch.cat(idx).numpy(), torch.cat(vals).numpy())
    assert (got == want).all()
    keys = [torch.from_numpy(rng.integers(0, 4, r)) for r in rows]
    pos = torch.cat(ex.rank(keys)).numpy()
    order = np.argsort(torch.cat(keys).numpy(), kind="stable")
    assert (pos[order] == np.arange(total)).all()
    assert ex.copies == 0 and ex.steps == (1 if n == 1 else 5) and ex.seconds >= 0
