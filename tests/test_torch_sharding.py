"""The port's placement helpers (consensus_specs_tpu_torch/parallel/
sharding.py), scenario for scenario of tests/test_sharding.py, held
against the JAX package on its 8 virtual CPU devices: mesh construction
(an over-ask raises, never repeats a device), leading-axis placement that
changes no bit (every array leaf Sharded with shard i on device i, 0-d
leaves Replicated), the hierarchical ("host", "v") grid, the unequal-tree
detector, the refusal of a non-divisible axis and the pow2 pad, the
ServingMesh's padding and row placement, and the mesh passed as an
explicit argument (the reference's environment switch,
test_serving_mesh_from_env, is not ported). The port's meshes are
ServingMesh(["cpu"] * n): shards sharing a device are still separate
tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu import telemetry as JT
from consensus_specs_tpu.parallel import sharding as JS
from consensus_specs_tpu.resilience import faults as JF
from consensus_specs_tpu_torch import telemetry as PT
from consensus_specs_tpu_torch.parallel import Replicated, Sharded
from consensus_specs_tpu_torch.parallel import sharding as PS
from consensus_specs_tpu_torch.resilience import faults as PF

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

N_DEV = 8
CPU8 = ["cpu"] * N_DEV


@pytest.fixture(autouse=True)
def _clean():
    for faults, tele in ((JF, JT), (PF, PT)):
        faults.set_schedule(None)
        tele.reset()
    yield
    for faults, tele in ((JF, JT), (PF, PT)):
        faults.set_schedule(None)
        tele.reset()


def _np_tree():
    return {"cols": np.arange(64, dtype=np.int64).reshape(8, 8),
            "flat": np.arange(16, dtype=np.int32),
            "scalar": np.int64(7)}


def _port_tree():
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in _np_tree().items()}


def _jax_tree():
    t = _np_tree()
    return {"cols": jnp.asarray(t["cols"].astype(np.uint64)), "flat": jnp.asarray(t["flat"]),
            "scalar": jnp.uint64(7)}


def test_validator_mesh_uses_the_given_devices():
    assert PS.validator_mesh(CPU8) == [torch.device("cpu")] * N_DEV
    assert PS.validator_mesh() == PS.visible_devices()
    assert len(JS.validator_mesh().devices) == len(jax.devices()) == N_DEV


def test_validator_mesh_subset_and_overask():
    assert len(PS.validator_mesh(CPU8, n=4)) == 4
    assert JS.validator_mesh(n=4).devices.shape == (4,)
    with pytest.raises(ValueError, match="need 9 devices"):
        PS.validator_mesh(CPU8, n=N_DEV + 1)
    with pytest.raises(AssertionError):
        JS.validator_mesh(n=N_DEV + 1)
    # no repeats of its own: the visible list is what there is
    with pytest.raises(ValueError):
        PS.validator_mesh(n=len(PS.visible_devices()) + 1)


def test_shard_leading_axis_roundtrip_bitwise():
    mesh = PS.ServingMesh(CPU8)
    tree = _port_tree()
    sharded = PS.shard_leading_axis(mesh, tree)
    assert PS.trees_bitwise_equal(tree, sharded)
    assert isinstance(sharded["cols"], Sharded) and isinstance(sharded["flat"], Sharded)
    assert isinstance(sharded["scalar"], Replicated)
    assert sharded["cols"].devices == mesh.devices
    # every shard its own tensor, its own rows
    ptrs = {s.data_ptr() for s in sharded["cols"].shards}
    assert len(ptrs) == N_DEV and tree["cols"].data_ptr() not in ptrs
    assert [tuple(s.shape) for s in sharded["flat"].shards] == [(2,)] * N_DEV
    # the same values the reference's placement holds, shard for shard
    jsh = JS.shard_leading_axis(JS.validator_mesh(), _jax_tree())
    for i, shard in enumerate(jsh["flat"].addressable_shards):
        assert np.array_equal(np.asarray(shard.data), sharded["flat"].shards[i].numpy())


def test_hierarchical_mesh_shapes():
    for hosts, shape in ((2, (2, 4)), (4, (4, 2))):
        assert PS.hierarchical_mesh(CPU8, hosts=hosts).shape == shape
        assert JS.hierarchical_mesh(hosts=hosts).devices.shape == shape
    assert PS.hierarchical_mesh(CPU8).shape == (1, N_DEV)
    with pytest.raises(ValueError):
        PS.hierarchical_mesh(CPU8, hosts=3)
    with pytest.raises(AssertionError):
        JS.hierarchical_mesh(hosts=3)


def test_shard_hierarchical_roundtrip_bitwise():
    grid = PS.hierarchical_mesh(CPU8, hosts=2)
    tree = _port_tree()
    sharded = PS.shard_hierarchical(grid, tree)
    assert PS.trees_bitwise_equal(tree, sharded)
    assert len(sharded["cols"].shards) == N_DEV      # the flattened (host, v) product
    assert isinstance(sharded["scalar"], Replicated)


def test_trees_bitwise_equal_detects_value_drift():
    a, b = _port_tree(), _port_tree()
    assert PS.trees_bitwise_equal(a, b) and JS.trees_bitwise_equal(_jax_tree(), _jax_tree())
    b["flat"][3] = 99
    assert not PS.trees_bitwise_equal(a, b)
    sb = PS.shard_leading_axis(PS.ServingMesh(CPU8), _port_tree())
    sb["flat"].shards[1][0] = 99
    assert not PS.trees_bitwise_equal(a, sb)


def test_trees_bitwise_equal_detects_dtype_shape_and_arity():
    a = _port_tree()
    assert not PS.trees_bitwise_equal(a, dict(a, cols=a["cols"].to(torch.int32)))
    assert not PS.trees_bitwise_equal(a, dict(a, cols=a["cols"].reshape(4, 16)))
    assert not PS.trees_bitwise_equal(a, {k: v for k, v in a.items() if k != "scalar"})
    j = _jax_tree()
    assert not JS.trees_bitwise_equal(j, dict(j, cols=j["cols"].astype(jnp.uint32)))


def test_trees_bitwise_equal_mixed_host_device_leaves():
    assert PS.trees_bitwise_equal({"x": np.arange(8, dtype=np.int64)},
                                  {"x": torch.arange(8, dtype=torch.int64)})
    assert JS.trees_bitwise_equal({"x": np.arange(8, dtype=np.uint64)},
                                  {"x": jnp.arange(8, dtype=jnp.uint64)})


def test_shard_leading_axis_rejects_non_divisible_axis():
    msgs = []
    for S, mesh, arr in ((PS, PS.ServingMesh(CPU8), torch.arange(33, dtype=torch.int32)),
                         (JS, JS.validator_mesh(), jnp.arange(33, dtype=jnp.uint32))):
        with pytest.raises(ValueError) as exc:
            S.shard_leading_axis(mesh, {"cols": arr})
        msgs.append(str(exc.value))
    for msg in msgs:
        assert "33" in msg and "8-device" in msg
        assert "pad_leading_pow2" in msg and "64" in msg


def test_pad_leading_pow2_makes_axis_shardable():
    mesh = PS.ServingMesh(CPU8)
    x = torch.arange(33, dtype=torch.int32)
    padded = PS.pad_leading_pow2(x, mesh)
    want = np.asarray(JS.pad_leading_pow2(jnp.arange(33, dtype=jnp.int32), JS.validator_mesh()))
    assert padded.shape == (64,) and np.array_equal(padded.numpy(), want)
    assert isinstance(PS.shard_leading_axis(mesh, padded), Sharded)
    y = torch.arange(16, dtype=torch.int32)
    assert PS.pad_leading_pow2(y, mesh) is y


def test_serving_mesh_is_an_explicit_argument():
    """The replacement of the reference's environment switch: a caller
    builds the mesh it wants; the size must be a power of two (refused,
    never rounded), CUDA is never chosen or dropped silently."""
    m = PS.ServingMesh(["cpu"] * 4)
    assert m.size == 4 and m.distinct_devices == 1 and m.home == torch.device("cpu")
    assert PS.ServingMesh.create(2, devices=CPU8).size == 2
    for bad in (["cpu"] * 6, ["cpu"] * 3, []):
        with pytest.raises(ValueError, match="power of two"):
            PS.ServingMesh(bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PS.ServingMesh(["cuda"] * 2)
        assert PS.ServingMesh.available() is None
    assert PS.ServingMesh.available(devices=CPU8).size == N_DEV
    assert PS.ServingMesh.available(devices=["cpu"] * 7).size == 4
    assert PS.ServingMesh.available(devices=["cpu"]) is None


def test_serving_mesh_padding_and_row_sharding():
    mesh = PS.ServingMesh(CPU8)
    jmesh = JS.ServingMesh.create(N_DEV)
    for n in (0, 1, 32, 33):
        assert mesh.pad_rows(n) == jmesh.pad_rows(n)
    assert [mesh.pad_rows(n) for n in (0, 1, 32, 33)] == [0, 8, 32, 40]
    for rows in (64, 8, 4, 1, 0):
        want = jmesh.row_sharding(rows) == jmesh.shard_v
        assert (mesh.row_sharding(rows) == mesh.shard_v) == want
    assert mesh.row_sharding(8) == mesh.shard_v and mesh.row_sharding(4) == mesh.replicated
    with pytest.raises(ValueError):
        PS.ServingMesh.create(3, devices=CPU8)
    assert PS.pow2_pad_rows(100, 8) == JS.pow2_pad_rows(100, 8) == 128


def test_mesh_device_loss_rounds_down_like_reference():
    """`mesh=lose:k` drops devices at construction (the reference's
    test_chaos_checkpoint.py::test_mesh_device_loss_rounds_down):
    ServingMesh.available re-plans to the largest surviving power of two,
    the loss is one-shot, and filter_devices keeps at least one device."""
    sizes = []
    for faults, S, T, kw in ((JF, JS, JT, {}), (PF, PS, PT, {"devices": CPU8})):
        faults.set_schedule("mesh@1=lose:1")
        mesh = S.ServingMesh.available(**kw)
        faults.set_schedule(None)
        sizes.append((mesh.size, T.counter("resilience.faults.lose", always=True).value,
                      S.ServingMesh.available(**kw).size))
    assert sizes[0] == sizes[1] == (4, 1, 8)
    for faults in (JF, PF):
        faults.set_schedule("mesh@1=lose:20")
        assert faults.filter_devices([1, 2, 3]) == [1]
        faults.set_schedule(None)
        assert faults.filter_devices([1, 2, 3]) == [1, 2, 3]
    PF.set_schedule("mesh@1=lose:3")
    assert PS.validator_mesh() == PS.visible_devices()[:max(1, len(PS.visible_devices()) - 3)]
