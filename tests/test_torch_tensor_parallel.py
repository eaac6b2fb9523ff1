"""moldiff_tpu_torch's model axis (Megatron tensor parallelism written out:
models/nn.py ShardedMLP, parallel/mesh.py tp_param_sharding; one gloo
process per rank) against moldiff_tpu's Trainer on JAX's (data, graph,
model) meshes of the conftest's virtual CPU devices, with
tests/torch_axes_util.py's tiny two-block model at float32:

- tp_param_sharding leaf by leaf against JAX's specs (each leaf's split
  dimension, shard shape and every rank's slice) on the flagship and
  predictor checkpoints' trees, a MoE tree and an MLP whose hidden width
  does not divide the axis;
- a train step with grad_accum 2 on an odd batch (the clip active), fed
  JAX's noise, on make_mesh_3d(1, 1, 2) and (1, 2, 2) against JAX's Trainer
  on the same mesh (params rtol 2e-5 / atol 2e-6), its whole gradient
  against jax.grad's (each leaf scaled by its largest, atol 3e-5), every
  rank's whole state bit-equal, each rank holding JAX's shard shapes; the eval terms on
  the TP mesh; the bond predictor's step (its 3-layer decoder's middle
  layer all-gathered) on (1, 2, 2);
- sharded checkpoints: a TP directory read at world 1, a world-1 one read
  by the TP ranks, a resume round trip, and JAX's own TP-mesh directory
  read into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moldiff_tpu.models.moe import init_moe_mlp as j_init_moe_mlp
from moldiff_tpu.models.nn import init_mlp as j_init_mlp
from moldiff_tpu.parallel import mesh as jmesh
from moldiff_tpu.train.checkpoint_sharded import save_checkpoint_sharded as j_save_sharded
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu_torch.parallel import launch
from moldiff_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh_3d, tp_param_sharding
from moldiff_tpu_torch.train import checkpoint_sharded
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy
from moldiff_tpu_torch.utils.tree import tree_leaves
from test_torch_data_parallel import (assert_aux_close, assert_state_close, batch, eval_noise,
                                      jax_state, train_cfg)
from torch_axes_util import (SPAWN_S, T_MAX, background, jax_model, mid_run, model_cfg, noise,
                             padded, run_kwargs, world_one)
from torch_dist_util import axis_worker, make_model, np_batch_to_torch, start_state
from torch_port_util import np_tree

MESHES = [(1, 1, 2), (1, 2, 2)]


def _trees() -> dict:
    moe = np_tree(j_init_moe_mlp(jax.random.key(2), 16, 16, 16, 4))
    return {"flagship_v2": load_checkpoint_numpy("ckpts/flagship_v2.ckpt")["params"],
            "bondpred_v2": load_checkpoint_numpy("ckpts/bondpred_v2.ckpt")["params"],
            "moe_and_odd_hidden": {"node_net": moe,
                                   "odd": np_tree(j_init_mlp(jax.random.key(0), 4, 4, 3)),
                                   "three": np_tree(j_init_mlp(jax.random.key(1), 4, 4, 6,
                                                               num_layer=3))}}


@pytest.mark.parametrize("tree", ["flagship_v2", "bondpred_v2", "moe_and_odd_hidden"])
@pytest.mark.parametrize("mesh", [(1, 1, 2), (2, 2, 2)])
def test_tp_param_sharding_equals_jax(tree, mesh):
    """Each leaf's split dimension, shard shape and every rank's slice
    equal JAX's NamedSharding on the 3-D mesh; the odd-hidden MLP and
    every non-MLP leaf are replicated, the MoE experts split."""
    params = _trees()[tree]
    jm = jmesh.make_mesh_3d(*mesh)
    want = jax.tree.leaves(jmesh.tp_param_sharding(jm, params))
    got = tree_leaves(tp_param_sharding(make_mesh_3d(*mesh), params))
    leaves = jax.tree.leaves(params)
    assert len(got) == len(want) == len(leaves)
    split = 0
    for x, p, s in zip(leaves, got, want):
        spec = tuple(s.spec) + (None,) * (x.ndim - len(s.spec))
        assert p.dim == next((d for d, a in enumerate(spec) if a == jmesh.MODEL_AXIS), None)
        assert p.dim is None or p.axis == MODEL_AXIS
        assert p.shard_shape == tuple(s.shard_shape(x.shape))
        index = s.devices_indices_map(x.shape)
        for (d, g, m), dev in np.ndenumerate(jm.devices):
            np.testing.assert_array_equal(x[p.index(m)], x[index[dev]])
        split += p.dim is not None
    assert split > 0
    if tree == "moe_and_odd_hidden":
        places = tp_param_sharding(make_mesh_3d(*mesh), params)
        assert all(q.dim is None for q in tree_leaves(places["odd"]))
        assert places["node_net"]["experts"]["layers"][0]["lin"]["w"].dim == 2


# -- training on (1, 1, 2) and (1, 2, 2) ------------------------------------------

@pytest.fixture(scope="module")
def tp_train(tmp_path_factory):
    """On each mesh a step of grad_accum 2 on B = 5 (padded to 8), the clip
    active. On (1, 1, 2) the eval terms after it; on (1, 2, 2) a TP
    directory and pickle written after it, the step taken again from the
    state and from the directory read back, a world-1 directory read by the
    TP ranks, and the bond predictor's step. JAX: its Trainer on each mesh,
    and its directory of the (1, 2, 2) state."""
    work = tmp_path_factory.mktemp("tp")
    params = np_tree(jax_model().init_params(jax.random.key(0)))
    tcfg = train_cfg(grad_accum=2, max_grad_norm=1.0)
    b = batch(5, seed=3)
    state = mid_run("moldiff", params, tcfg, b)
    key, ekey = jax.random.key(21), jax.random.key(5)
    # JAX pads a batch to data x grad_accum: 6 rows at data 1
    steps = [(np_batch_to_torch(b), noise("moldiff", key, 6, 2))]
    evals = (np_batch_to_torch(b), eval_noise("moldiff", ekey, 6, T_MAX["moldiff"]))
    one = Trainer(make_model("moldiff", model_cfg(), 8, 6), tcfg)
    one.save_checkpoint_sharded(str(work / "w1"), start_state(one, state), {"model": model_cfg()})
    bparams = np_tree(jax_model("bond").init_params(jax.random.key(0)))
    bcfg = train_cfg("bond")
    bb = batch(4, seed=4, kind="bond")
    bstate = mid_run("bond", bparams, bcfg, bb)
    bsteps = [(np_batch_to_torch(bb), noise("bond", jax.random.key(17), 4))]
    futures = {
        (1, 1, 2): background(launch.spawn, axis_worker, 2, args=(
            [run_kwargs("moldiff", tcfg, state, steps, {"graph": 1, "model": 2},
                        eval_batch=evals, grad_check=True)],), timeout_s=SPAWN_S),
        (1, 2, 2): background(launch.spawn, axis_worker, 4, args=(
            [run_kwargs("moldiff", tcfg, state, steps, {"graph": 2, "model": 2},
                        ckpt_dir=str(work / "tp"), read_dir=str(work / "w1"), grad_check=True),
             run_kwargs("bond", bcfg, bstate, bsteps, {"graph": 2, "model": 2})],),
            timeout_s=SPAWN_S)}
    out = {"work": work, "state": state}
    for mesh in MESHES:
        jt = JTrainer(jax_model(), tcfg, mesh=jmesh.make_mesh_3d(*mesh))
        assert jt.tp
        out[mesh] = jt.train_step(jax_state(jt, state), b, key)
        if mesh == (1, 1, 2):
            out["jax_eval"] = jt.eval_step(out[mesh][0].params, b, ekey)
        else:
            j_save_sharded(str(work / "jax_tp"), out[mesh][0])
    bt = JTrainer(jax_model("bond"), bcfg, mesh=jmesh.make_mesh_3d(1, 2, 2))
    out["bond_jax"] = bt.train_step(jax_state(bt, bstate), bb, jax.random.key(17))
    out["one"] = world_one("moldiff", tcfg, state,
                           [(np_batch_to_torch(padded(b, 6)), steps[0][1])])
    # JAX's gradient of the step: the mean of its two microbatches' (3 rows
    # each), each from its key of split(key, 2), as trainer.py:194-225
    jt = JTrainer(jax_model(), tcfg)
    jp = jax.tree.map(jnp.asarray, state["params"])
    grad = jax.jit(jax.grad(lambda p, mb, k: jt.loss_fn(p, mb, k)[0]))
    bp = padded(b, 6)
    gs = [grad(jp, {k: v[3 * i:3 * i + 3] for k, v in bp.items()}, k)
          for i, k in enumerate(jax.random.split(key, 2))]
    out["jax_grads"] = [np.asarray((x + y) / 2) for x, y in zip(*map(jax.tree.leaves, gs))]
    out["bond_one"] = world_one("bond", bcfg, bstate, bsteps)
    out["ranks"] = {mesh: f.result() for mesh, f in futures.items()}
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_train_step_equals_jax(tp_train, mesh):
    """Loss terms and the whole state after the step against JAX's Trainer
    on the mesh: the shards' gradients whole per model rank, summed over
    data alone; the clip norm over the whole leaves."""
    jst, jaux = tp_train[mesh]
    assert float(jaux["grad_norm"]) > 1.0
    for r, ranks in enumerate(tp_train["ranks"][mesh]):
        rec = ranks[0]
        assert rec["tp"] and rec["graph"]
        assert_aux_close(rec["aux"][0], jaux, tp_train["one"][0][0])
        assert_state_close(rec["states"][-1], jst, f"{mesh} rank {r}")
        assert rec["states"][-1]["step"] == int(jst.step)


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_gradient_equals_jax(tp_train, mesh):
    """The whole gradient of the step (the model's collectives, the
    microbatches' mean), gathered from the shards, against jax.grad's:
    each leaf scaled by its largest, atol 3e-5, on every rank."""
    for rank in tp_train["ranks"][mesh]:
        got = rank[0]["grads"]
        assert len(got) == len(tp_train["jax_grads"])
        for g, w in zip(got, tp_train["jax_grads"]):
            scale = max(1e-6, float(np.abs(w).max()))
            np.testing.assert_allclose(g / scale, w / scale, atol=3e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_ranks_hold_equal_whole_states_in_jax_shards(tp_train, mesh):
    """Every rank's whole state is bit-equal; each holds JAX's shard shapes
    of params, moments and EMA."""
    jst, _ = tp_train[mesh]
    ranks = [r[0] for r in tp_train["ranks"][mesh]]
    for rec in ranks[1:]:
        for name in ("params", "ema", "mu", "nu"):
            for x, y in zip(tree_leaves(rec["states"][-1][name]),
                            tree_leaves(ranks[0]["states"][-1][name])):
                np.testing.assert_array_equal(x, y)
    want = [tuple(s.data.shape) for x in jax.tree.leaves(jst.params)
            for s in x.addressable_shards[:1]]
    for rec in ranks:
        assert rec["shapes"]["params"] == want
        assert rec["shapes"]["mu"] == rec["shapes"]["ema"] == want


def test_tp_eval_step_equals_jax(tp_train):
    want = tp_train["jax_eval"]
    for rec in (r[0] for r in tp_train["ranks"][(1, 1, 2)]):
        for k, v in want.items():
            assert rec["eval"][k] == pytest.approx(float(v), rel=1e-5, abs=1e-6), k


def test_tp_sharded_checkpoint_round_trips(tp_train):
    """The TP directory and pickle read at world 1 hold the whole state; a
    step from the directory read back on the TP mesh is bit-equal to the
    same step from the state; a world-1 directory read by the TP ranks
    gives them the whole mid-run state, in TP shards."""
    work, rec = tp_train["work"], tp_train["ranks"][(1, 2, 2)][0][0]
    full = checkpoint_sharded.load_checkpoint_sharded(str(work / "tp"))["state"]
    pickled = load_checkpoint_numpy(str(work / "tp.ckpt"))
    for name, key in (("params", "params"), ("ema", "ema_params")):
        for x, y, z in zip(tree_leaves(full[key]), tree_leaves(rec["states"][-1][name]),
                           tree_leaves(pickled[key])):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(z, y)
    assert type(pickled["params"]["node_decoder"]) is dict
    assert int(full["step"]) == rec["states"][-1]["step"] == rec["resumed_step"]
    (aux_a, st_a), (aux_b, st_b) = rec["last"], rec["again"]
    assert aux_a == aux_b
    for name in ("params", "ema", "mu"):
        for x, y in zip(tree_leaves(st_a[0][name]), tree_leaves(st_b[0][name])):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(tree_leaves(rec["read"]["params"]),
                    tree_leaves(tp_train["state"]["params"])):
        np.testing.assert_array_equal(x, y)
    assert rec["read_shapes"] == rec["shapes"]["params"]


def test_tp_jax_directory_reads(tp_train):
    """JAX's directory of its (1, 2, 2) state reads into the port: params,
    EMA and step; the port's params' leaf files are named as JAX's."""
    import os

    work = tp_train["work"]
    jst, _ = tp_train[(1, 2, 2)]
    blob = checkpoint_sharded.load_checkpoint_sharded(str(work / "jax_tp"))["state"]
    for key in ("params", "ema_params"):
        for x, y in zip(tree_leaves(blob[key]), jax.tree.leaves(getattr(jst, key))):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert int(blob["step"]) == int(jst.step)
    n = len(jax.tree.leaves(jst.params))
    names = lambda d: sorted(f for f in os.listdir(d) if f.startswith("leaf")
                             and int(f[4:].split("_")[0]) < n)
    assert names(work / "tp") == names(work / "jax_tp")


def test_tp_bond_predictor_step_equals_jax(tp_train):
    """The predictor on (1, 2, 2): its 3-layer edge decoder's middle layer
    runs on the all-gathered hidden; the step equals JAX's."""
    bnew, baux = tp_train["bond_jax"]
    for r, ranks in enumerate(tp_train["ranks"][(1, 2, 2)]):
        rec = ranks[1]
        assert rec["tp"]
        assert_aux_close(rec["aux"][0], baux, tp_train["bond_one"][0][0])
        assert_state_close(rec["states"][0], bnew, f"bond rank {r}")
