"""The port's resilience layer (consensus_specs_tpu_torch.resilience:
faults, the guard's fault branch, integrity, the ladder, the health
snapshot) held against the JAX package's on the same inputs, on the CPU:

  * the schedule grammar parses the same texts into the same entries and
    rejects the same malformed ones; occurrence counting and key globs
    fire on the same calls; the byte mutations are identical for a seed;
  * poison_tree corrupts the same leaf with the same value (a uint64
    leaf's maximum is the int64 bit pattern -1 in the port);
  * guarded_dispatch's raise / fatal / hang / poison branches and the
    pre-dispatch allowance give the same results, typed errors, sleeps
    and counters on a fake clock;
  * the tripwire's hulls are the reference's declarations, and
    epoch_output_check / finite_check give the reference's verdicts on
    clean and corrupt outputs (uint64 values of 2^63 and more included);
  * the ladder is full, then single_device (the reference's rungs
    without those that swap a kernel for its plain twin):
    run_with_recovery fails exactly as the reference's does at the
    bottom of its ladder;
  * health_snapshot has the reference's shape and counters.
No test sleeps: the clock and the sleeper are injected."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu import resilience as JR
from consensus_specs_tpu import telemetry as JT
from consensus_specs_tpu.models.phase0 import epoch_soa as JE
from consensus_specs_tpu.resilience import dispatch as JD
from consensus_specs_tpu.resilience import faults as JF
from consensus_specs_tpu.resilience import integrity as JI
from consensus_specs_tpu.telemetry import watchdog as JW
from consensus_specs_tpu_torch import resilience as PR
from consensus_specs_tpu_torch import telemetry as PT
from consensus_specs_tpu_torch.models.phase0 import epoch_soa as PE
from consensus_specs_tpu_torch.resilience import dispatch as PD
from consensus_specs_tpu_torch.resilience import errors as PErr
from consensus_specs_tpu_torch.resilience import faults as PF
from consensus_specs_tpu_torch.resilience import integrity as PI
from consensus_specs_tpu_torch.telemetry import watchdog as PW

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

COUNTERS = ("retries", "transient_errors", "fatal_errors", "corrupt_outputs",
            "deadline_misses", "deadline_salvaged", "faults_injected",
            "faults.raise", "faults.fatal", "faults.hang", "faults.poison",
            "degradations")


def _reset():
    for faults, res, tele, wd in ((JF, JR, JT, JW), (PF, PR, PT, PW)):
        faults.set_schedule(None)
        res.ladder().reset()
        tele.reset()
        wd.reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    yield
    _reset()


def _counts(T):
    return {n: T.counter(f"resilience.{n}", always=True).value for n in COUNTERS}


# ---------------------------------------------------------------------------
# The schedule grammar
# ---------------------------------------------------------------------------

VALID = [
    "seed=42;dispatch:*epoch*@2=raise;dispatch:*@5-7=hang:150;"
    "ckpt.write@1=truncate:33;ckpt.read@2=bitflip:4;mesh@1=lose:2",
    "dispatch:*epoch*@1=poison:6",
    "seed=7;dispatch:*mesh.epoch*@1=raise;dispatch:*mesh.epoch*@2=poison:6;"
    "dispatch:*mesh.epoch*@3=hang:400;ckpt.write@2=truncate:33",
    "dispatch@1-99=fatal; ckpt.write@3=crash:0.4 ;;ckpt.read@1=truncate",
    "",
]
INVALID = ["dispatch@0=raise", "dispatch@3-2=raise", "nosite@1=raise",
           "ckpt.write@1=poison", "mesh:glob@1=lose:1", "dispatch@x=raise",
           "dispatch=raise", "dispatch@1", "seed=x", "ckpt.read@1=crash"]


def _entries(sched):
    return sched.seed, [(e.site, e.glob, e.lo, e.hi, e.action, e.param, e.text)
                        for e in sched.entries]


@pytest.mark.parametrize("text", VALID)
def test_valid_schedules_parse_like_the_reference(text):
    assert _entries(PF.parse_schedule(text)) == _entries(JF.parse_schedule(text))


@pytest.mark.parametrize("text", INVALID)
def test_invalid_schedules_raise_like_the_reference(text):
    with pytest.raises(ValueError):
        JF.parse_schedule(text)
    with pytest.raises(ValueError):
        PF.parse_schedule(text)


def test_occurrence_counting_and_globs_match_reference():
    text = ("dispatch:*epoch*@2=raise;dispatch:*epoch*@2-3=hang:5;"
            "dispatch:*firehose*@1-2=poison:1;dispatch@7=fatal")
    keys = [("mesh.other",), ("resident0", "epoch", 64), ("firehose.batch", 3, 4),
            ("resident0", "epoch", 64), ("resident0", "epoch", 64),
            ("firehose.flush", 1024), "x", ("firehose.batch", 3, 4),
            ("resident0", "epoch", 64)]
    seen = []
    for faults in (JF, PF):
        faults.set_schedule(text)
        seen.append([(f.action, f.param, f.entry) if f else None
                     for f in map(faults.on_dispatch, keys)])
        assert faults.active()
        faults.set_schedule(None)
        assert not faults.active() and faults.on_dispatch(keys[1]) is None
    assert seen[0] == seen[1]
    assert [s and s[0] for s in seen[1]] == [None, None, "poison", "raise",
                                             "hang", "poison", "fatal", None, None]
    assert _counts(PT) == _counts(JT)


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_byte_mutations_match_reference(seed):
    data = bytes(random.Random(seed).randrange(256) for _ in range(97))
    for action, param in (("truncate", "33"), ("truncate", None),
                          ("truncate", "999"), ("bitflip", "40"),
                          ("bitflip", None), ("bitflip", "5000")):
        want = JF._mutate_bytes(data, JF.Fault(action, param, ""), random.Random(seed))
        got = PF._mutate_bytes(data, PF.Fault(action, param, ""), random.Random(seed))
        assert got == want, (action, param)
    text = f"seed={seed};ckpt.write@1=bitflip;ckpt.write@2=crash:0.4;ckpt.read@1-2=bitflip"
    out = []
    for faults in (JF, PF):
        faults.set_schedule(text)
        out.append([faults.on_checkpoint_write(data), faults.on_checkpoint_write(data),
                    faults.on_checkpoint_write(data), faults.on_checkpoint_read(data),
                    faults.on_checkpoint_read(data), faults.on_checkpoint_read(data)])
    assert out[0] == out[1]
    assert out[1][1][1] is True and len(out[1][1][0]) == int(len(data) * 0.4)


# ---------------------------------------------------------------------------
# poison_tree
# ---------------------------------------------------------------------------

def _epoch_np(V=16, seed=3):
    rng = np.random.default_rng(seed)
    cols = JE.ValidatorColumns(
        *[rng.integers(0, 1 << 40, V, dtype=np.uint64) for _ in range(4)],
        np.arange(V) % 3 == 1,
        rng.integers(0, 32 * 10 ** 9, V, dtype=np.uint64),
        rng.integers(0, 1 << 44, V, dtype=np.uint64))
    scal = JE.EpochScalars(*[np.asarray(x, np.uint64) for x in (4096, 60, 61, 7, 59, 17)],
                           latest_slashed_balances=rng.integers(0, 1 << 50, 8, dtype=np.uint64))
    report = JE.EpochReport(*[np.asarray(b) for b in (False, False, True, False)])
    return cols, scal, report


def _to_jax(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [_to_jax(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _port_type(tree):
    """The port's namedtuple of the same name, for the reference's."""
    name = type(tree).__name__
    return getattr(PE, name) if hasattr(PE, name) else type(tree)


def _to_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [_to_torch(x) for x in tree]
        return _port_type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_port_np(leaf):
    """A leaf as the port holds it (uint64 -> int64 bits), as numpy."""
    a = np.asarray(leaf)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _mixed_tree():
    rng = np.random.default_rng(11)
    return {"b": rng.integers(-9, 9, (3, 2)).astype(np.int32),
            "a": rng.standard_normal(5).astype(np.float32),
            "c": (np.arange(4, dtype=np.uint8), None, np.asarray(False)),
            "d": rng.integers(0, 1 << 63, 6, dtype=np.uint64)}


@pytest.mark.parametrize("tree_name, leaf", [
    ("epoch", "0"), ("epoch", "4"), ("epoch", "6"), ("epoch", "7"), ("epoch", "13"),
    ("epoch", "14"), ("epoch", "99"), ("epoch", None),
    ("mixed", "0"), ("mixed", "1"), ("mixed", "2"), ("mixed", "3"), ("mixed", "4"),
    ("mixed", "5")])
def test_poison_tree_matches_reference(tree_name, leaf):
    """The same leaf, in the reference's flatten order, gets the same
    value: NaN, True, the dtype's maximum (-1 bits for uint64); every
    other leaf and the input are unchanged."""
    tree = _epoch_np() if tree_name == "epoch" else _mixed_tree()
    want = JF.poison_tree(_to_jax(tree), leaf)
    src = _to_torch(tree)
    got = PF.poison_tree(src, leaf)
    import jax
    w_leaves = jax.tree_util.tree_leaves(want)
    g_leaves = PF.tree_leaves(got)
    assert len(g_leaves) == len(w_leaves) == len(PF.tree_leaves(src))
    changed = []
    for k, (w, g, s) in enumerate(zip(w_leaves, g_leaves, PF.tree_leaves(src))):
        np.testing.assert_array_equal(g.numpy(), _as_port_np(w))
        if not torch.equal(g, s):
            changed.append(k)
    assert len(changed) == 1
    assert changed[0] == min(int(leaf or 0), len(w_leaves) - 1)
    assert type(got) is type(src)
    if tree_name == "epoch":
        assert [type(x).__name__ for x in got] == [type(x).__name__ for x in tree]
        if leaf == "6":
            assert int(got[0].balance[0]) == -1     # uint64 max as int64 bits


# ---------------------------------------------------------------------------
# The guard's fault branch on a fake clock
# ---------------------------------------------------------------------------

def _clock():
    t = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        t[0] += s
    return (lambda: t[0]), sleep, slept


SCENARIOS = {
    # name: (schedule, guard kwargs, fn output in range?)
    "raise": ("dispatch:*g*@1=raise", dict(), True),
    "raise_exhausts": ("dispatch:*g*@1-9=raise", dict(retries=1), True),
    "fatal": ("dispatch:*g*@1=fatal", dict(), True),
    "hang_retried": ("dispatch:*g*@1=hang:400", dict(deadline_ms=100.0), True),
    "hang_exhausts": ("dispatch:*g*@1-3=hang:400", dict(deadline_ms=100.0, retries=1), True),
    "hang_salvaged": ("dispatch:*g*@1=hang:400", dict(deadline_ms=100.0, retries=0), True),
    "poison_redispatch": ("dispatch:*g*@1=poison:0", dict(check=True), True),
    "poison_at_zero_retries": ("dispatch:*g*@1=poison:0", dict(check=True, retries=0), True),
    "predispatch_allowance": ("dispatch:*g*@1-2=raise", dict(retries=0), True),
    "allowance_exhausts": ("dispatch:*g*@1-3=raise", dict(retries=0), True),
    "late_and_corrupt": ("dispatch:*g*@1=hang:400",
                         dict(deadline_ms=100.0, retries=0, check=True), False),
    "unarmed": (None, dict(check=True), True),
}


def _guard(D, faults, arr, schedule, kwargs, in_range):
    faults.set_schedule(schedule)
    clock, sleep, slept = _clock()
    calls = []
    kw = dict(kwargs)
    if kw.pop("check", False):
        kw["check"] = lambda o: bool((o < 1000).all()) and bool(o[0] >= 0)

    def fn(x):
        calls.append(1)
        return x if in_range else -x - 1

    try:
        out = D.guarded_dispatch(("g", 1), fn, arr, clock=clock, sleep=sleep, **kw)
        result = ("ok", np.asarray(out).tolist())
    except Exception as exc:     # noqa: BLE001 - the typed error is the result
        result = (type(exc).__name__, getattr(exc, "attempts", None),
                  getattr(exc, "consumed_inputs", None))
    return result, len(calls), slept


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_guard_fault_branch_matches_reference(name):
    schedule, kwargs, in_range = SCENARIOS[name]
    x = np.arange(8, dtype=np.int64)
    want = _guard(JD, JF, jnp.asarray(x), schedule, kwargs, in_range)
    got = _guard(PD, PF, torch.from_numpy(x), schedule, kwargs, in_range)
    assert got == want
    assert _counts(PT) == _counts(JT)


def test_injected_fault_classes_and_deadline_default():
    assert PD.classify(PErr.InjectedFault("INTERNAL: injected transient")) == "transient"
    assert PD.classify(PErr.InjectedFault("INVALID_ARGUMENT: injected fatal")) == "fatal"
    assert issubclass(PErr.InjectedFault, RuntimeError)
    assert issubclass(PErr.SimulatedCrash, PErr.ResilienceError)
    assert not issubclass(PErr.SimulatedCrash, PErr.CheckpointCorrupt)
    with pytest.raises(PErr.InjectedFault, match="INTERNAL"):
        PF.raise_injected("k", PF.Fault("raise", None, "e"))
    assert PD.deadline_ms_default() == 0.0
    clock, sleep, _ = _clock()
    PD.set_deadline_ms_default(100.0)
    try:
        PF.set_schedule("dispatch:*d*@1=hang:400")
        # the default budget arms the guard when deadline_ms is None
        assert PD.guarded_dispatch(("d",), lambda: torch.ones(1), clock=clock,
                                   sleep=sleep) is not None
        assert PT.counter("resilience.deadline_misses", always=True).value == 1
        assert PR.health_snapshot()["deadline_ms"] == 100.0
    finally:
        PD.set_deadline_ms_default(None)
    assert PR.health_snapshot()["deadline_ms"] is None


# ---------------------------------------------------------------------------
# Integrity
# ---------------------------------------------------------------------------

def test_hulls_equal_the_reference_declarations():
    assert PI.declared_epoch_hulls() == JI.declared_epoch_hulls()
    assert PI.declared_epoch_scalar_hulls() == JI.declared_epoch_scalar_hulls()
    for p, j in ((PI.declared_epoch_hulls, JI.declared_epoch_hulls),
                 (PI.declared_epoch_scalar_hulls, JI.declared_epoch_scalar_hulls)):
        assert PI._finite_items(p()) == JI._finite_items(j())
    assert set(PI.declared_epoch_hulls()) == set(PE.ValidatorColumns._fields)
    assert set(PI.declared_epoch_scalar_hulls()) == set(PE.EpochScalars._fields)


def _set(tree, part, field, value):
    parts = list(tree)
    arr = np.array(getattr(parts[part], field))
    arr.reshape(-1)[0] = value
    parts[part] = parts[part]._replace(**{field: arr})
    return tuple(parts)


U = np.uint64
CHECK_CASES = {
    "clean": lambda t: t,
    "balance_2^63": lambda t: _set(t, 0, "balance", U(1 << 63)),
    "balance_max": lambda t: _set(t, 0, "balance", U((1 << 64) - 1)),
    "balance_at_hull": lambda t: _set(t, 0, "balance", U(1 << 45)),
    "balance_past_hull": lambda t: _set(t, 0, "balance", U((1 << 45) + 1)),
    "effective_past_hull": lambda t: _set(t, 0, "effective_balance", U(32 * 10 ** 9 + 1)),
    "exit_epoch_far_future": lambda t: _set(t, 0, "exit_epoch", U((1 << 64) - 1)),
    "slashed_flip": lambda t: _set(t, 0, "slashed", True),
    "slot_2^40": lambda t: _set(t, 1, "slot", U(1 << 40)),
    "slot_2^63": lambda t: _set(t, 1, "slot", U(1 << 63)),
    "start_shard_1024": lambda t: _set(t, 1, "latest_start_shard", U(1024)),
    "bitfield_max": lambda t: _set(t, 1, "justification_bitfield", U((1 << 64) - 1)),
    "slashed_balances_2^59+1": lambda t: _set(t, 1, "latest_slashed_balances", U((1 << 59) + 1)),
    "no_scalars": lambda t: (t[0],),
}


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_epoch_output_check_matches_reference(case):
    tree = CHECK_CASES[case](_epoch_np())
    want = JI.epoch_output_check(_to_jax(tree) if len(tree) == 3
                                 else (_to_jax(tree[0]), None, None))
    got = PI.epoch_output_check(_to_torch(tree))
    assert got == want
    assert want == (case in ("clean", "balance_at_hull", "exit_epoch_far_future",
                             "slashed_flip", "bitfield_max", "no_scalars"))


@pytest.mark.parametrize("leaf", ["5", "6", "7", "9", "13"])
def test_poisoned_epoch_output_trips_like_the_reference(leaf):
    tree = _epoch_np()
    want = JI.epoch_output_check(JF.poison_tree(_to_jax(tree), leaf))
    got = PI.epoch_output_check(PF.poison_tree(_to_torch(tree), leaf))
    assert got == want is False


def test_finite_check_matches_reference():
    tree = _mixed_tree()
    for mutate in (lambda t: t,
                   lambda t: dict(t, a=np.where(np.arange(5) == 2, np.inf, t["a"]).astype(np.float32)),
                   lambda t: dict(t, e=np.asarray([1.0, -np.inf]))):
        t = mutate(tree)
        assert PI.finite_check(_to_torch(t)) == JI.finite_check(_to_jax(t))
    assert not PI.finite_check(PF.poison_tree(_to_torch(tree), "0"))
    assert PI.finite_check(_to_torch({"x": np.arange(3)}))


def test_tripwire_switch():
    assert PI.tripwires_enabled()
    PI.set_tripwires(False)
    try:
        assert not PI.tripwires_enabled()
    finally:
        PI.set_tripwires(None)
    assert PI.tripwires_enabled()


# ---------------------------------------------------------------------------
# The ladder and the health snapshot
# ---------------------------------------------------------------------------

def _exhausting(counter):
    def make():
        def fn():
            counter.append(1)
            raise RuntimeError("UNAVAILABLE: forever")
        return fn, ()
    return make


def test_ladder_has_one_rung_and_recovery_fails_like_the_reference_at_its_bottom():
    """The port's ladder is the reference's without its kernel-swapping
    rungs: full, then single_device; at the bottom of both, recovery
    fails the same way."""
    lad = PD.DegradationLadder()
    assert PD.DegradationLadder.RUNGS == ("full", "single_device")
    assert PD.DegradationLadder.RUNGS[-1] == JD.DegradationLadder.RUNGS[-1]
    assert lad.rung_name == "full" and not lad.exhausted
    assert lad.degrade("weather") == "single_device" and lad.rung == 1
    assert lad.exhausted and lad.degrade("weather") is None and lad.rung == 1
    jlad = JD.DegradationLadder()
    try:
        while jlad.degrade("to the bottom") is not None:
            pass
        JT.reset()
        PT.reset()
        out = []
        for D, L in ((JD, jlad), (PD, lad)):
            calls = []
            with pytest.raises(D.FatalDispatchError) as ei:
                D.run_with_recovery(("r", 2), _exhausting(calls), ladder=L,
                                    retries=1, sleep=lambda s: None)
            out.append((ei.value.attempts, ei.value.key, len(calls),
                        type(ei.value.__cause__).__name__))
    finally:
        jlad.reset()
    assert out[0] == out[1] == (2, ("r", 2), 2, "TransientDispatchError")
    assert _counts(PT) == _counts(JT)
    lad.reset()
    assert PT.gauge("resilience.rung", always=True).value == 0


def test_health_snapshot_matches_reference():
    """The same scenario through both packages: a retried raise, a
    rejected output, a checkpoint save; the snapshots agree except the
    list of rungs."""
    snaps = []
    for D, faults, R, T in ((JD, JF, JR, JT), (PD, PF, PR, PT)):
        arr = jnp.arange(4) if R is JR else torch.arange(4)
        faults.set_schedule("dispatch:*h*@1=raise")
        D.guarded_dispatch(("h",), lambda x: x, arr, sleep=lambda s: None)
        with pytest.raises(D.CorruptOutput):
            D.guarded_dispatch(("c",), lambda x: x, arr, retries=0,
                               check=lambda o: False)
        T.gauge("resilience.checkpoint.generation", always=True).set(3)
        T.counter("resilience.checkpoint.saves", always=True).inc()
        snaps.append(R.health_snapshot())
        R.reset()
        assert not faults.active()
    want, got = snaps
    assert want["rung"].pop("of") == list(JD.DegradationLadder.RUNGS)
    assert got["rung"].pop("of") == ["full", "single_device"]
    assert got == want
    assert got["counters"]["retries"] == 1 and got["counters"]["corrupt_outputs"] == 1
    assert got["faults_active"] is True and got["checkpoint"]["last_good_generation"] == 3
    assert PR.snapshot()["status"] == "ok"
