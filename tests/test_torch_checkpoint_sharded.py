"""moldiff_tpu_torch's sharded checkpoint directories
(train/checkpoint_sharded.py) against moldiff_tpu's, after JAX's cases
(tests/test_checkpoint_sharded.py): a 2-rank FSDP trainer writes one (gloo
processes on the CPU); it round-trips exactly; shard files are partial and
a missing one is refused; it is read resharded at W = 1 and 4; scheduler
and key round-trip; a trainer resumes from it; the temporary directory is
renamed into place only when whole; each params leaf file equals the file
JAX's save_checkpoint_sharded writes for the same params under the same
FSDP placement; and a directory JAX wrote is read (its treedef decoded
without jaxlib), or refused with the reason when it cannot be."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moldiff_tpu.parallel.mesh import fsdp_param_sharding as j_fsdp, make_mesh
from moldiff_tpu.train.checkpoint_sharded import save_checkpoint_sharded as j_save
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu.train.trainer import TrainState as JTrainState
from moldiff_tpu_torch.parallel import launch
from moldiff_tpu_torch.parallel.mesh import fsdp_placement
from moldiff_tpu_torch.train import checkpoint_sharded as cs
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.tree import tree_leaves
from test_torch_data_parallel import TYPES, jax_model, model_cfg, train_cfg
from torch_dist_util import ckpt_worker, make_model
from torch_port_util import np_tree


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A 2-rank FSDP trainer's sharded checkpoint and the whole state."""
    params = np_tree(jax_model("moldiff").init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    state = {"params": params, "step": 7, "count": 5,
             "mu": jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params),
             "nu": jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32), params),
             "ema": jax.tree.map(lambda x: x * 0.5, params)}
    path = str(tmp_path_factory.mktemp("ck") / "7.ckpt")
    kn, ke = TYPES["moldiff"]
    out = launch.spawn(ckpt_worker, 2, args=("moldiff", model_cfg(), kn, ke, train_cfg(), state,
                                             path, True), timeout_s=240)
    return {"path": path, "whole": out[0], "params": params}


def _assert_whole(loaded: dict, whole: dict):
    st = loaded["state"]
    for name, want in (("params", whole["params"]), ("ema_params", whole["ema"]),
                       ("mu", whole["mu"]), ("nu", whole["nu"])):
        got = st["opt_state"][name] if name in ("mu", "nu") else st[name]
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(x, y)
    assert int(st["step"]) == whole["step"] and int(st["opt_state"]["count"]) == whole["count"]
    assert float(st["opt_state"]["lr"]) == whole["lr"]


def test_roundtrip(written):
    loaded = cs.load_checkpoint_sharded(written["path"])
    _assert_whole(loaded, written["whole"])
    assert loaded["config"] == {"model": model_cfg()}
    assert not os.path.exists(written["path"] + ".tmp")


def test_shard_files_are_partial(written, tmp_path):
    """A sharded leaf is two files, each half of it; without one of them
    the load is refused (not filled with garbage)."""
    files = sorted(os.listdir(written["path"]))
    leaf0 = [f for f in files if f.startswith("leaf0_o")]
    p0 = written["params"]
    want = jax.tree.leaves(p0)[0]
    place = fsdp_placement(want.shape, 2)
    assert place.dim is not None and len(leaf0) == 2
    for f in leaf0:
        assert np.load(os.path.join(written["path"], f)).shape == place.shard_shape
    broken = str(tmp_path / "broken")
    shutil.copytree(written["path"], broken)
    os.remove(os.path.join(broken, leaf0[1]))
    with pytest.raises(ValueError, match="cover"):
        cs.load_checkpoint_sharded(broken)


@pytest.mark.parametrize("world", [1, 4])
def test_reshard_on_load(written, world):
    """Read at another world size: each rank's slice under W's placement
    (JAX's rule) equals the whole leaf's slice."""
    whole = written["whole"]
    for rank in range(world):
        def select(path, shape):
            if path[0] in ("params", "ema_params") or path[:2] in (("opt_state", "mu"),
                                                                    ("opt_state", "nu")):
                return fsdp_placement(shape, world).index(rank)
            return None
        st = cs.load_checkpoint_sharded(written["path"], select=select)["state"]
        for x, y in zip(tree_leaves(st["params"]), tree_leaves(whole["params"])):
            place = fsdp_placement(y.shape, world)
            np.testing.assert_array_equal(x, y[place.index(rank)])
        for x, y in zip(tree_leaves(st["opt_state"]["nu"]), tree_leaves(whole["nu"])):
            np.testing.assert_array_equal(x, y[fsdp_placement(y.shape, world).index(rank)])


def test_scheduler_and_key_roundtrip(written, tmp_path):
    meta = cs.read_meta(written["path"])
    assert meta["scheduler"] == written["whole"]["scheduler"] and meta["world"] == 2
    path = str(tmp_path / "k")
    entries = [(("params", "w"), np.arange(6, dtype=np.float32).reshape(2, 3),
                fsdp_placement((2, 3), 1)), (("step",), np.asarray(3, np.int32),
                                             fsdp_placement((), 1))]
    key = np.array([0, 42], np.uint32)
    cs.save_checkpoint_sharded(path, entries, config={"a": 1}, key=key, extra={"x": 2})
    out = cs.load_checkpoint_sharded(path)
    np.testing.assert_array_equal(out["key"], key)
    assert out["extra"] == {"x": 2} and out["config"] == {"a": 1}
    assert out["state"]["params"]["w"].shape == (2, 3) and int(out["state"]["step"]) == 3
    assert sorted(os.listdir(path)) == ["leaf0_o0_0.npy", "leaf1_or.npy", "meta.pkl"]


def test_trainer_resumes_from_directory(written):
    """A world-1 trainer resumes the 2-rank directory: params, EMA, moments,
    count, learning rate and step."""
    kn, ke = TYPES["moldiff"]
    tr = Trainer(make_model("moldiff", model_cfg(), kn, ke), train_cfg())
    st = tr.load_checkpoint(written["path"], "cpu")
    whole = written["whole"]
    assert st.step == whole["step"] and st.opt_state.count == whole["count"]
    assert st.opt_state.lr == whole["lr"]
    assert tr.scheduler.state_dict() == whole["scheduler"]
    for got, want in ((st.params, whole["params"]), (st.ema_params, whole["ema"]),
                      (st.opt_state.mu, whole["mu"]), (st.opt_state.nu, whole["nu"])):
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(x.numpy(), y)


def test_atomic_temporary_directory(tmp_path, monkeypatch):
    """A stale <path>.tmp is replaced; a save that fails midway leaves the
    previous directory in place and no partial one under the name."""
    path = str(tmp_path / "a.ckpt")
    os.makedirs(path + ".tmp")
    open(os.path.join(path + ".tmp", "junk"), "w").close()
    entry = [(("params", "w"), np.ones((4,), np.float32), fsdp_placement((4,), 1))]
    cs.save_checkpoint_sharded(path, entry)
    assert not os.path.exists(path + ".tmp") and "junk" not in os.listdir(path)
    calls = []

    def failing_save(f, arr):
        calls.append(f)
        raise OSError("disk full")
    monkeypatch.setattr(cs.np, "save", failing_save)
    with pytest.raises(OSError):
        cs.save_checkpoint_sharded(path, [(("params", "w"), np.zeros((4,), np.float32),
                                           fsdp_placement((4,), 1))])
    monkeypatch.undo()
    assert calls
    np.testing.assert_array_equal(cs.load_checkpoint_sharded(path)["state"]["params"]["w"],
                                  np.ones(4))


@pytest.fixture(scope="module")
def jax_dir(written, tmp_path_factory):
    """JAX's sharded checkpoint of the same params under the same FSDP
    placement on a 2-device mesh (EMA: the same leaves as written)."""
    jt = JTrainer(jax_model("moldiff"), train_cfg(), mesh=make_mesh(2), fsdp=True)
    whole = written["whole"]
    jp = jax.tree.map(jnp.asarray, whole["params"])
    state = JTrainState(jp, jt.optimizer.init(jp), jnp.asarray(whole["step"], jnp.int32),
                        jax.tree.map(jnp.asarray, whole["ema"]))
    state = jax.device_put(state, jt._state_sharding(state))
    path = str(tmp_path_factory.mktemp("jax") / "7.ckpt")
    j_save(path, state, model_config={"model": model_cfg()}, scheduler=jt.scheduler,
           key=jax.random.key(3))
    return path


def test_params_leaf_files_equal_jax(written, jax_dir):
    """Params leaf i is JAX's leaf i: the same files (names: offsets under
    the same placement) with the same bytes."""
    n = len(jax.tree.leaves(written["params"]))
    sharded = 0
    for i in range(n):
        mine = sorted(f for f in os.listdir(written["path"]) if f.startswith(f"leaf{i}_o"))
        theirs = sorted(f for f in os.listdir(jax_dir) if f.startswith(f"leaf{i}_o"))
        assert mine == theirs, i
        sharded += len(mine) > 1
        for f in mine:
            with open(os.path.join(written["path"], f), "rb") as a, \
                    open(os.path.join(jax_dir, f), "rb") as b:
                assert a.read() == b.read(), f
    assert sharded > n // 2
    placements = jax.tree.leaves(j_fsdp(make_mesh(2), written["params"]))
    assert sum(len(s.spec) > 0 and any(s.spec) for s in placements) == sharded


def test_reads_a_jax_written_directory(written, jax_dir):
    """The port reads JAX's directory: params, EMA and step, its treedef
    decoded without jaxlib (the optax state is not returned); a trainer
    starts from it with a fresh optimizer."""
    meta = cs.read_meta(jax_dir)
    assert meta["paths"][0][0] == "params" and ("step",) in meta["paths"]
    out = cs.load_checkpoint_sharded(jax_dir)
    st = out["state"]
    assert st["opt_state"] is None and int(st["step"]) == written["whole"]["step"]
    for got, want in ((st["params"], written["whole"]["params"]),
                      (st["ema_params"], written["whole"]["ema"])):
        assert len(tree_leaves(got)) == len(tree_leaves(want))
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(x, y)
    assert out["config"] == {"model": model_cfg()}
    kn, ke = TYPES["moldiff"]
    tr = Trainer(make_model("moldiff", model_cfg(), kn, ke), train_cfg())
    ts = tr.load_checkpoint(jax_dir, "cpu")
    assert ts.step == written["whole"]["step"] and ts.opt_state.count == 0


@jax.tree_util.register_pytree_node_class
class Box:
    """A custom pytree node."""

    def __init__(self, x):
        self.x = x

    def tree_flatten(self):
        return (self.x,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def test_refuses_an_undecodable_treedef(tmp_path):
    """A treedef with a node this reader cannot rebuild without JAX (a
    custom pytree node) is refused, saying why."""
    path = str(tmp_path / "c")
    j_save(path, JTrainState({"w": jnp.ones(2)}, Box(jnp.zeros(1)), jnp.asarray(1), None))
    with pytest.raises(ValueError, match="without JAX"):
        cs.load_checkpoint_sharded(path)
