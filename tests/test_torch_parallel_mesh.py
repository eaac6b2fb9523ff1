"""moldiff_tpu_torch.parallel.mesh against moldiff_tpu.parallel.mesh:
make_mesh_from_config over JAX's cases (sizes, the pipe, expert, graph and
model meshes and their rank layout, the axes' exclusivity, the
divisibility errors, NCCL's one rank per card), fsdp_param_sharding's dimension and per-rank shard shapes leaf by
leaf against JAX's on W = 2 and 4 meshes for the flagship and demo
trees, pad_batch_to_multiple and shard_batch."""
import jax
import numpy as np
import pytest
import torch

from moldiff_tpu.parallel import mesh as jmesh
from moldiff_tpu_torch.data.batching import pad_batch_to_multiple
from moldiff_tpu_torch.parallel import mesh
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy


@pytest.mark.parametrize("cfg", [
    {"num_devices": 8}, {"num_devices": 4}, {"num_devices": 2, "fsdp": True}, {"num_devices": 1},
    {"num_devices": 8, "graph": 1, "model": 1, "pipe": 1, "expert": 1},
])
def test_data_mesh_sizes_equal_jax(cfg):
    want = jmesh.make_mesh_from_config(cfg, devices=jax.devices())
    got = mesh.make_mesh_from_config(cfg, "cpu")
    assert got.shape == {mesh.DATA_AXIS: want.shape[jmesh.DATA_AXIS]} and got.backend == "gloo"
    assert got.world_size == want.size and got.rank == 0


def test_null_num_devices_is_every_visible_device():
    assert mesh.make_mesh_from_config({"num_devices": None}, "cpu").data == 1
    assert mesh.make_mesh_from_config(None, "cpu").data == 1


@pytest.mark.parametrize("cfg", [
    {"num_devices": 8, "pipe": 2, "graph": 2}, {"num_devices": 8, "pipe": 2, "model": 2},
    {"num_devices": 8, "expert": 2, "graph": 2}, {"num_devices": 8, "expert": 2, "pipe": 2},
    {"num_devices": 6, "graph": 4}, {"num_devices": 6, "model": 4}, {"num_devices": 3, "pipe": 2},
    {"num_devices": 5, "expert": 2},
])
def test_errors_equal_jax(cfg):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh_from_config(cfg, devices=jax.devices())
    with pytest.raises(ValueError) as got:
        mesh.make_mesh_from_config(cfg, "cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis", ["graph", "model", "pipe", "expert"])
def test_axes_not_ported_raise(axis):
    """Every axis builds JAX's mesh: its axes and sizes (a model axis comes
    with a graph axis of size 1, as make_mesh_3d gives it), and each rank at
    JAX's device: rank d * A + a on a 2-D mesh, (d * G + g) * M + m on the
    3-D one, with each axis's line of ranks."""
    cfg = {"num_devices": 4, axis: 2}
    want = jmesh.make_mesh_from_config(cfg, devices=jax.devices())
    got = mesh.make_mesh_from_config(cfg, "cpu")
    assert got.shape == dict(want.shape) and got.world_size == want.size
    assert tuple(got.axes) == tuple(want.axis_names)
    assert (mesh.pipe_enabled(got), mesh.ep_enabled(got), mesh.tp_enabled(got),
            mesh.graph_enabled(got)) == (axis == "pipe", axis == "expert", axis == "model",
                                         axis in ("graph", "model"))
    ids = [d.id for d in jax.devices()]
    for coords, dev in np.ndenumerate(want.devices):
        r = got.at(ids.index(dev.id), "cpu")
        assert tuple(r.coord(a) for a in got.axes) == coords
        if axis in ("pipe", "expert"):
            d, a = coords
            assert (r.data_rank, r.axis_rank) == (d, a)
            assert (r.group_rank(mesh.DATA_AXIS, 0), r.group_rank(axis, 0)) == (a, 2 * d)
        else:
            strides = np.cumprod((1,) + want.devices.shape[:0:-1])[::-1]
            assert r.rank == int(np.dot(coords, strides))
            for k, a in enumerate(got.axes):
                line = [int(np.dot(coords[:k] + (c,) + coords[k + 1:], strides))
                        for c in range(got.size(a))]
                assert [r.group_rank(a, c) for c in range(got.size(a))] == line


@pytest.mark.parametrize("cfg", [{"num_devices": 8, "graph": 2, "model": 2},
                                 {"num_devices": 8, "graph": 2}, {"num_devices": 8, "model": 4},
                                 {"num_devices": 2, "graph": 2, "fsdp": True}])
def test_graph_model_meshes_equal_jax(cfg):
    """make_mesh_from_config's (data, graph) and (data, graph, model)
    meshes: JAX's axes, sizes and rank layout; pair_sharding's axes."""
    want = jmesh.make_mesh_from_config(cfg, devices=jax.devices())
    got = mesh.make_mesh_from_config(cfg, "cpu")
    assert tuple(got.axes) == tuple(want.axis_names) and got.shape == dict(want.shape)
    ids = [d.id for d in jax.devices()]
    for coords, dev in np.ndenumerate(want.devices):
        r = got.at(ids.index(dev.id), "cpu")
        assert tuple(r.coord(a) for a in got.axes) == coords
    assert (jmesh.pair_sharding(want) is not None) == mesh.graph_enabled(got)
    assert jmesh.tp_enabled(want) == mesh.tp_enabled(got)


def test_nccl_takes_one_rank_per_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        mesh.make_mesh_from_config({"num_devices": 2}, "cuda")
    shared = mesh.make_mesh_from_config({"num_devices": 2}, "cuda", backend="gloo")
    assert shared.data == 2 and shared.device == torch.device("cuda", 0)
    assert mesh.make_mesh_from_config({"num_devices": None}, "cuda").backend == "nccl"
    assert mesh.rank_device("cuda", 1) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no cuda device"):
        mesh.make_mesh_from_config(None, "cuda")


@pytest.mark.parametrize("ckpt", ["ckpts/flagship_v2.ckpt", "ckpts/demo_synthetic_30k.ckpt",
                                  "ckpts/bondpred_v2.ckpt"])
@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_placement_equals_jax(ckpt, world):
    """Each leaf's sharded dimension and each rank's shard shape and
    slice equal JAX's NamedSharding on a W-device mesh."""
    params = load_checkpoint_numpy(ckpt)["params"]
    leaves = jax.tree.leaves(params)
    want = jax.tree.leaves(jmesh.fsdp_param_sharding(jmesh.make_mesh(world), params))
    got = jax.tree.leaves(mesh.fsdp_param_sharding(world, params),
                          is_leaf=lambda x: isinstance(x, mesh.Placement))
    assert len(got) == len(want) == len(leaves)
    n_sharded = 0
    for x, p, s in zip(leaves, got, want):
        spec = tuple(s.spec) + (None,) * (x.ndim - len(s.spec))
        dim = next((d for d, a in enumerate(spec) if a == jmesh.DATA_AXIS), None)
        assert p.dim == dim, (x.shape, p, s.spec)
        assert p.shard_shape == tuple(s.shard_shape(x.shape))
        index = s.devices_indices_map(x.shape)
        for r, dev in enumerate(jmesh.make_mesh(world).devices.flat):
            np.testing.assert_array_equal(x[p.index(r)], x[index[dev]])
        n_sharded += p.dim is not None
    assert n_sharded > len(leaves) // 2


def _batch(b: int) -> dict:
    rng = np.random.default_rng(0)
    n = 6
    return {"node_type": rng.integers(1, 7, (b, n)).astype(np.int32),
            "pos": rng.normal(size=(b, n, 3)).astype(np.float32),
            "halfedge_type": rng.integers(0, 5, (b, n * (n - 1) // 2)).astype(np.int32),
            "node_mask": np.ones((b, n), np.float32)}


@pytest.mark.parametrize("b,multiple", [(5, 4), (8, 4), (3, 2), (1, 8)])
def test_pad_batch_to_multiple_equals_jax(b, multiple):
    batch = _batch(b)
    want = jmesh.pad_batch_to_multiple(batch, multiple)
    got = pad_batch_to_multiple({k: torch.tensor(v) for k, v in batch.items()}, multiple)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert got["node_mask"].shape[0] % multiple == 0


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_equals_jax(world):
    """Rank r's rows are the shard of JAX's batch sharding on device r."""
    jm = jmesh.make_mesh(world)
    batch = _batch(8)
    placed = jmesh.shard_batch(batch, jm)
    for r, dev in enumerate(jm.devices.flat):
        mine = mesh.shard_batch({k: torch.tensor(v) for k, v in batch.items()},
                                mesh.Mesh(data=world).at(r, "cpu"))
        for k in batch:
            shard = next(s for s in placed[k].addressable_shards if s.device == dev)
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch({"x": torch.zeros(3)}, mesh.Mesh(data=2))
