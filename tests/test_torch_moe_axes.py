"""moldiff_tpu_torch's MoE beside the graph and model axes (models/denoiser.py
node_edge_net_sharded with the expert bank on the replicated nodes, its
experts' MLPs split over model) and FSDP beside a pipe axis that runs no
pipeline (the bond predictor's), one gloo process per rank, against
moldiff_tpu on JAX's meshes of the conftest's virtual CPU devices, with
tests/torch_axes_util.py's tiny two-block model (node 16, edge 8) at
float32 and a 2-expert top-2 bank whose capacity factor of 0.5 drops
tokens:

- node_edge_net on make_mesh_3d(1, 2, 2) at N = 7 (padded receiver rows;
  the capacity from the real N), each rank holding its tp_param_sharding
  shards: the outputs and the load-balance loss at rtol 2e-5 / atol 2e-6,
  the gradients of a weighted sum of them with respect to the block
  params and the inputs, each leaf scaled by its largest, atol 3e-5;
- one MoE train step on make_mesh_3d(1, 2, 2) and on make_mesh_2d(2, 2)
  (the bank's data all-gathers beside graph), the clip active, fed JAX's
  noise, against JAX's Trainer on the same mesh: loss, loss_moe and params
  (rtol 2e-5 / atol 2e-6), every rank's whole state bit-equal;
- the bond predictor with FSDP on data 2 x pipe 2 against JAX's
  Trainer(fsdp=True) on make_mesh_pipe(2, 2) (fsdp on, pp off): the step's
  terms and state, each rank holding its data coordinate's FSDP shards,
  the pipe replicas' states bit-equal.

All ranks run in one process group of 4, in a thread while JAX computes
its side."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moldiff_tpu.models.denoiser import init_node_edge_net as j_init_net
from moldiff_tpu.models.denoiser import node_edge_net as j_node_edge_net
from moldiff_tpu.parallel import mesh as jmesh
from moldiff_tpu.parallel.pipeline import make_mesh_pipe as j_make_mesh_pipe
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu_torch.parallel import launch
from moldiff_tpu_torch.utils.tree import tree_leaves
from test_torch_data_parallel import (assert_aux_close, assert_state_close, batch, jax_state,
                                      train_cfg)
from torch_axes_util import (SPAWN_S, background, jax_model, mid_run, model_cfg, noise,
                             run_kwargs, world_one)
from torch_dist_util import forward_and_axis_worker, np_batch_to_torch
from torch_port_util import np_tree

MOE = {"num_experts": 2, "top_k": 2, "capacity_factor": 0.5}
NET = {"num_blocks": 2, "cutoff": 10.0, "use_gate": True, "moe": MOE}
MESH3D = {"graph": 2, "model": 2}
# the MoE train steps: (name, axes beside data, JAX's mesh)
STEPS = [("graph2_model2", MESH3D, lambda: jmesh.make_mesh_3d(1, 2, 2)),
         ("data2_graph2", {"graph": 2}, lambda: jmesh.make_mesh_2d(2, 2))]


def moe_cfg() -> dict:
    cfg = copy.deepcopy(model_cfg())
    cfg["denoiser"]["moe"] = dict(MOE)
    return cfg


def _inputs(b: int = 4, n: int = 7) -> tuple:
    """Denoiser inputs (node 16 / edge 8), the node mask, and the weights of
    the summed outputs (a scalar for the load-balance loss)."""
    rng = np.random.default_rng(n)
    h_node = rng.normal(size=(b, n, 16)).astype(np.float32)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32)
    h_edge = rng.normal(size=(b, n, n, 8)).astype(np.float32)
    t = rng.random((b, 1, 1)).astype(np.float32)
    node_mask = (rng.random((b, n)) > 0.2).astype(np.float32)
    pm = node_mask[:, :, None] * node_mask[:, None, :] * (1.0 - np.eye(n, dtype=np.float32))
    weights = [rng.normal(size=x.shape).astype(np.float32) for x in (h_node, pos, h_edge)]
    return [h_node, pos, h_edge, t, t * 0.5, pm, node_mask], weights + [np.float32(0.7)]


@pytest.fixture(scope="module")
def runs():
    """The port's forward and train steps on 4 ranks in one process group,
    spawned at once; JAX's node_edge_net under pair_sharding with
    tp_param_sharding's placement, and JAX's Trainer on each mesh."""
    jp, static = j_init_net(jax.random.key(0), 16, 8, **NET)
    inputs, weights = _inputs()
    forward = dict(axes=MESH3D, params=np_tree(jp), static_cfg=NET, inputs=inputs,
                   weights=weights)

    tcfg = train_cfg(max_grad_norm=1.0)
    b = batch(4, seed=3)
    params = np_tree(jax_model(cfg=moe_cfg()).init_params(jax.random.key(0)))
    state = mid_run("moldiff", params, tcfg, b, cfg=moe_cfg())
    key = jax.random.key(21)
    steps = [(np_batch_to_torch(b), noise("moldiff", key, 4))]
    bparams = np_tree(jax_model("bond").init_params(jax.random.key(0)))
    bcfg = train_cfg("bond")
    bb = batch(4, seed=4, kind="bond")
    bstate = mid_run("bond", bparams, bcfg, bb)
    bkey = jax.random.key(17)
    bsteps = [(np_batch_to_torch(bb), noise("bond", bkey, 4))]
    kws = [run_kwargs("moldiff", tcfg, state, steps, axes, cfg=moe_cfg())
           for _, axes, _ in STEPS]
    kws.append(run_kwargs("bond", bcfg, bstate, bsteps, {"pipe": 2}, fsdp=True))
    future = background(launch.spawn, forward_and_axis_worker, 4, args=(forward, kws),
                        timeout_s=SPAWN_S)

    out = {}
    jm = jmesh.make_mesh_3d(1, 2, 2)
    ps = jmesh.pair_sharding(jm)
    placed = jax.device_put(jp, jmesh.tp_param_sharding(jm, jp))
    rest = [jnp.asarray(x) for x in inputs[3:6]]
    node_mask = jnp.asarray(inputs[6])

    def fn(p, h, pos, e):
        res = j_node_edge_net(p, static, h, pos, e, *rest, remat=False, pair_sharding=ps,
                              node_mask=node_mask)
        return sum(jnp.sum(o * w) for o, w in zip(res, weights)), res

    (_, res), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2, 3), has_aux=True))(
        placed, *(jnp.asarray(x) for x in inputs[:3]))
    out["forward"] = {"out": [np.asarray(x) for x in res],
                      "grads": [np.asarray(x) for x in jax.tree.leaves(grads[0])],
                      "input_grads": [np.asarray(x) for x in grads[1:]]}
    for name, _, mesh in STEPS:
        jt = JTrainer(jax_model(cfg=moe_cfg()), tcfg, mesh=mesh())
        assert jt.model.pair_sharding is not None and jt.tp == ("model" in name)
        out[name] = jt.train_step(jax_state(jt, state), b, key)
    bt = JTrainer(jax_model("bond"), bcfg, mesh=j_make_mesh_pipe(2, 2), fsdp=True)
    assert bt.fsdp and not bt.pp
    out["bond_fsdp_pipe"] = bt.train_step(jax_state(bt, bstate), bb, bkey)
    out["one"] = world_one("moldiff", tcfg, state, steps, cfg=moe_cfg())
    out["bond_one"] = world_one("bond", bcfg, bstate, bsteps)
    out["ranks"] = future.result()
    return out


def test_moe_node_edge_net_on_graph_and_model_equals_jax(runs):
    """Every rank's outputs and load-balance loss are JAX's (replicated over
    graph and model); its input gradients too."""
    want = runs["forward"]
    assert len(want["out"]) == 4
    for rank, rec in enumerate(r["forward"] for r in runs["ranks"]):
        assert rec["split"] > 0
        for x, w in zip(rec["out"], want["out"]):
            np.testing.assert_allclose(x, w, rtol=2e-5, atol=2e-6, err_msg=f"rank {rank}")
        for g, w in zip(rec["input_grads"], want["input_grads"]):
            scale = max(1e-6, float(np.abs(w).max()))
            np.testing.assert_allclose(g / scale, w / scale, atol=3e-5)


def test_moe_node_edge_net_gradients_equal_jax(runs):
    """The block params' gradients, gathered from each rank's shards, equal
    jax.grad's on every rank: the routers' and the experts' included, the
    load-balance loss's share counted once over graph."""
    want = runs["forward"]["grads"]
    for rank, rec in enumerate(r["forward"] for r in runs["ranks"]):
        assert len(rec["grads"]) == len(want)
        for g, w in zip(rec["grads"], want):
            scale = max(1e-6, float(np.abs(w).max()))
            np.testing.assert_allclose(g / scale, w / scale, atol=3e-5, err_msg=f"rank {rank}")


@pytest.mark.parametrize("i,name", list(enumerate(name for name, *_ in STEPS)))
def test_moe_train_step_on_graph_axes_equals_jax(runs, i, name):
    """loss, loss_moe and the whole state after the step against JAX's
    Trainer on the mesh; every rank's whole state bit-equal to rank 0's."""
    jst, jaux = runs[name]
    assert float(jaux["grad_norm"]) > 1.0 and float(jaux["loss_moe"]) > 0
    ranks = [r["runs"][i] for r in runs["ranks"]]
    for r, rec in enumerate(ranks):
        assert rec["graph"] and rec["tp"] == ("model" in name)
        assert "loss_moe" in rec["aux"][0]
        assert_aux_close(rec["aux"][0], jaux, runs["one"][0][0])
        assert_state_close(rec["states"][-1], jst, f"{name} rank {r}")
        for key in ("params", "ema", "mu", "nu"):
            for x, y in zip(tree_leaves(rec["states"][-1][key]),
                            tree_leaves(ranks[0]["states"][-1][key])):
                np.testing.assert_array_equal(x, y)


def test_fsdp_beside_a_pipe_without_a_pipeline_equals_jax(runs):
    """The bond predictor with FSDP on data 2 x pipe 2: the step equals
    JAX's Trainer(fsdp=True) on make_mesh_pipe(2, 2); each rank holds its
    data coordinate's shards, the same as its pipe replica's, and the
    replicas' whole states are bit-equal."""
    jst, jaux = runs["bond_fsdp_pipe"]
    ranks = [r["runs"][len(STEPS)] for r in runs["ranks"]]
    full = [x.shape for x in tree_leaves(ranks[0]["states"][-1]["params"])]
    for r, rec in enumerate(ranks):
        assert rec["fsdp"] and not rec["pp"]
        assert_aux_close(rec["aux"][0], jaux, runs["bond_one"][0][0])
        assert_state_close(rec["states"][-1], jst, f"FSDP beside pipe rank {r}")
        assert rec["shapes"]["params"] != full
        replica = ranks[r ^ 1]
        assert rec["shapes"] == replica["shapes"]
        for key in ("params", "ema", "mu", "nu"):
            for x, y in zip(tree_leaves(rec["states"][-1][key]),
                            tree_leaves(replica["states"][-1][key])):
                np.testing.assert_array_equal(x, y)
