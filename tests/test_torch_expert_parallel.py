"""moldiff_tpu_torch's MoE training on a data axis and on the expert axis
(models/moe.py MoEComm, one gloo process per rank) against moldiff_tpu's
Trainer on the same meshes of the conftest's virtual CPU devices, where
GSPMD computes the expert bank over the global tokens:

- ep_param_sharding leaf by leaf against JAX's specs on the MoE tree;
- one MoE train step at (data 2, expert 2), at data 4 and at data 2, fed
  JAX's noise for the global batch: loss, loss_moe and params (rtol 2e-5 /
  atol 2e-6), top-2 with a capacity factor of 0.5, so that tokens overflow
  the capacity and the global positions decide which are kept, and top-1
  at data 2; every rank's whole state bit-equal;
- the expert axis's sharded checkpoints: an EP2 directory read at world 1,
  a world-1 one read by the EP2 ranks, a resume round trip, the params'
  leaf files named as JAX's, and JAX's own expert directory read into the
  port.

A narrow 2-block MolDiff at float32 with 4 experts (tests/test_torch_data_parallel.py's
helpers). The spawned ranks run in a thread while JAX computes its side."""
import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.parallel import mesh as jmesh
from moldiff_tpu.train.checkpoint_sharded import save_checkpoint_sharded as j_save_sharded
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu_torch.models import denoiser
from moldiff_tpu_torch.models import moe as tmoe
from moldiff_tpu_torch.parallel import launch
from moldiff_tpu_torch.parallel.mesh import ep_param_sharding, make_mesh_expert
from moldiff_tpu_torch.train import checkpoint_sharded
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy, params_to_torch
from moldiff_tpu_torch.utils.tree import tree_leaves
from test_torch_data_parallel import TYPES, assert_state_close, batch, jax_state, step_noise, \
    train_cfg
from test_torch_data_parallel import model_cfg as dense_cfg
from torch_dist_util import axis_worker, make_model, np_batch_to_torch, start_state
from torch_port_util import np_tree

SPAWN_S = 240
KN, KE = TYPES["moldiff"]
TOP2 = {"num_experts": 4, "top_k": 2, "capacity_factor": 0.5}
TOP1 = {"num_experts": 4, "top_k": 1, "capacity_factor": 1.0}
# (name, moe settings, mesh axes beside data, world); the JAX mesh of each
RUNS = [("ep2", TOP2, {"expert": 2}, 4), ("dp4", TOP2, None, 4), ("dp2", TOP2, None, 2),
        ("dp2_top1", TOP1, None, 2)]
JAX_MESH = {"ep2": lambda: jmesh.make_mesh_expert(2, 2), "dp4": lambda: jmesh.make_mesh(4),
            "dp2": lambda: jmesh.make_mesh(2), "dp2_top1": lambda: jmesh.make_mesh(2)}


def moe_cfg(moe: dict) -> dict:
    cfg = dense_cfg()
    cfg["denoiser"]["moe"] = dict(moe)
    return cfg


def _background(fn, *args, **kw):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kw)
    pool.shutdown(wait=False)
    return future


def moe_mid_run(params: dict, moe: dict, tcfg: dict, b: dict, noise) -> dict:
    """A state ten steps into a run on the MoE tree, as
    test_torch_data_parallel.mid_run makes one: adam's count 10, mu 0, nu
    1e-2 x the square of each leaf's gradient scale, EMA a copy."""
    tr = Trainer(make_model("moldiff", moe_cfg(moe), KN, KE), dict(tcfg, grad_accum=1))
    grads, _, _ = tr.gradient(tr.init_from_params(params_to_torch(params, "cpu")),
                              np_batch_to_torch(b), noise)
    nu = [np.full(g.shape, 1e-2 * float(g.abs().max()) ** 2 + 1e-12, np.float32) for g in grads]
    return {"params": params, "step": 100, "count": 10,
            "mu": jax.tree.map(np.zeros_like, params),
            "nu": jax.tree.unflatten(jax.tree.structure(params), nu), "ema": params}


def dropped_choices(params: dict, moe: dict, b: dict, noise) -> list:
    """Per MoE layer of the port's world-1 step, the real tokens' choices
    beyond an expert's capacity (all the batch's tokens: the global
    capacity)."""
    calls = []

    def spy(p, x, node_mask, cfg):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"]["w"].float(), -1)
        mask = node_mask.reshape(-1).float()
        sels, _ = tmoe.gates(probs, mask, tmoe.choose(probs, cfg["top_k"]))
        capacity = int(np.ceil(cfg["capacity_factor"] * cfg["top_k"] * mask.numel()
                               / probs.shape[-1]))
        calls.append(int(torch.clamp(sum(sel.sum(0) for sel in sels) - capacity, min=0).sum()))
        return tmoe.moe_mlp(p, x, node_mask, cfg)

    tr = Trainer(make_model("moldiff", moe_cfg(moe), KN, KE), train_cfg())
    orig, denoiser.moe_mlp = denoiser.moe_mlp, spy
    try:
        tr.gradient(tr.init_from_params(params_to_torch(params, "cpu")), np_batch_to_torch(b),
                    noise)
    finally:
        denoiser.moe_mlp = orig
    return calls


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """Each of RUNS: the port's step (the 4-rank runs in one process group,
    the 2-rank ones in another, both spawned at once) and JAX's Trainer on
    its mesh; the EP2 run also writes and reads sharded directories."""
    work = tmp_path_factory.mktemp("ep")
    tcfg = train_cfg()
    b = batch(4, seed=5)
    noise = step_noise("moldiff", jax.random.key(31), 4, 1, 1000)
    states, jaxes = {}, {}
    for moe in (TOP2, TOP1):
        params = np_tree(JMolDiff(moe_cfg(moe), KN, KE).init_params(jax.random.key(3)))
        states[moe["top_k"]] = moe_mid_run(params, moe, tcfg, b, noise[0])
    one = Trainer(make_model("moldiff", moe_cfg(TOP2), KN, KE), tcfg)
    one.save_checkpoint_sharded(str(work / "w1"), start_state(one, states[2]),
                                {"model": moe_cfg(TOP2)})
    steps = [(np_batch_to_torch(b), noise)]
    runs = {4: [], 2: []}
    for name, moe, axes, world in RUNS:
        kw = dict(kind="moldiff", model_cfg=moe_cfg(moe), kn=KN, ke=KE, train_cfg=tcfg,
                  state=states[moe["top_k"]], steps=steps, axes=axes)
        if name == "ep2":
            kw.update(ckpt_dir=str(work / "ep2"), read_dir=str(work / "w1"))
        runs[world].append((name, kw))
    futures = {w: _background(launch.spawn, axis_worker, w, args=([kw for _, kw in r],),
                              timeout_s=SPAWN_S) for w, r in runs.items()}
    for name, moe, axes, world in RUNS:
        jt = JTrainer(JMolDiff(moe_cfg(moe), KN, KE), tcfg, mesh=JAX_MESH[name]())
        assert jt.ep == bool(axes)
        jaxes[name] = jt.train_step(jax_state(jt, states[moe["top_k"]]), b, jax.random.key(31))
    j_save_sharded(str(work / "jax_ep2"), jaxes["ep2"][0])
    got = {}
    for w, r in runs.items():
        ranks = futures[w].result()
        for i, (name, _) in enumerate(r):
            got[name] = [rank[i] for rank in ranks]
    return {"work": work, "state": states, "batch": b, "noise": noise, "jax": jaxes,
            "got": got}


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_moe_step_equals_jax_mesh(moe_runs, name):
    """loss, loss_moe and the params after the step against JAX's Trainer
    on the same mesh; every rank's whole state bit-equal to rank 0's."""
    jnew, jaux = moe_runs["jax"][name]
    ranks = moe_runs["got"][name]
    for r, rec in enumerate(ranks):
        assert rec["ep"] == (name == "ep2")
        got = rec["aux"][0]
        for k in ("loss", "loss_moe", "loss_pos", "loss_node", "loss_edge"):
            assert got[k] == pytest.approx(float(jaux[k]), rel=1e-5, abs=1e-7), (k, r)
        assert_state_close(rec["states"][0], jnew, f"{name} rank {r}")
        for x, y in zip(tree_leaves(rec["states"][0]["params"]),
                        tree_leaves(ranks[0]["states"][0]["params"])):
            np.testing.assert_array_equal(x, y)


def test_capacity_overflows_in_the_top2_runs(moe_runs):
    """The top-2 settings drop real tokens' choices at the global capacity,
    so the runs above hold the global positions, not only the routing."""
    for moe in (TOP2, TOP1):
        dropped = dropped_choices(moe_runs["state"][moe["top_k"]]["params"], moe,
                                  moe_runs["batch"], moe_runs["noise"])
        assert len(dropped) == 2 and (min(dropped) > 0 if moe is TOP2 else True), dropped


def test_ep_param_sharding_equals_jax(moe_runs):
    """Each expert leaf split on dim 1 ([num_blocks, E, ...]), routers and
    every dense leaf replicated, each rank's slice JAX's, at expert 2 and
    4; the EP2 ranks hold their half of each expert bank."""
    params = moe_runs["state"][2]["params"]
    leaves = jax.tree.leaves(params)
    for n in (2, 4):
        jm = jmesh.make_mesh_expert(2, n)
        want = jax.tree.leaves(jmesh.ep_param_sharding(jm, params))
        got = tree_leaves(ep_param_sharding(make_mesh_expert(2, n), params))
        assert len(got) == len(want) == len(leaves)
        for x, p, s in zip(leaves, got, want):
            spec = tuple(s.spec) + (None,) * (x.ndim - len(s.spec))
            assert p.dim == next((d for d, a in enumerate(spec) if a == jmesh.EXPERT_AXIS), None)
            assert p.shard_shape == tuple(s.shard_shape(x.shape))
            index = s.devices_indices_map(x.shape)
            for (d, e), dev in np.ndenumerate(jm.devices):
                np.testing.assert_array_equal(x[p.index(e)], x[index[dev]])
        assert sum(p.dim == 1 for p in got) == len(tree_leaves(
            params["denoiser"]["blocks"]["node_block"]["node_net"]["experts"]))
    rec = moe_runs["got"]["ep2"][0]
    places = tree_leaves(ep_param_sharding(2, params))
    assert rec["shapes"]["params"] == [p.shard_shape for p in places]


def test_ep_sharded_checkpoints(moe_runs):
    """The EP2 directory read at world 1 holds the whole state; a step
    from it read back on the expert mesh is bit-equal to the step from the
    state; a world-1 directory read by the EP2 ranks gives them the whole
    state in expert shards; the params' leaf files are named as JAX's
    directory of the same placement names them; JAX's directory reads into
    the port: params, EMA and step."""
    work, rec = moe_runs["work"], moe_runs["got"]["ep2"][0]
    full = checkpoint_sharded.load_checkpoint_sharded(str(work / "ep2"))["state"]
    pickled = load_checkpoint_numpy(str(work / "ep2.ckpt"))
    for x, y, z in zip(tree_leaves(full["params"]), tree_leaves(rec["states"][0]["params"]),
                       tree_leaves(pickled["params"])):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(z, y)
    (aux_a, st_a), (aux_b, st_b) = rec["last"], rec["again"]
    assert aux_a == aux_b
    for x, y in zip(tree_leaves(st_a[0]["params"]), tree_leaves(st_b[0]["params"])):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tree_leaves(rec["read"]["params"]),
                    tree_leaves(moe_runs["state"][2]["params"])):
        np.testing.assert_array_equal(x, y)
    assert rec["read_shapes"] == rec["shapes"]["params"]
    jnew, _ = moe_runs["jax"]["ep2"]
    n = len(jax.tree.leaves(jnew.params))
    names = lambda d: sorted(f for f in os.listdir(d) if f.startswith("leaf")
                             and int(f[4:].split("_")[0]) < n)
    assert names(work / "ep2") == names(work / "jax_ep2")
    blob = checkpoint_sharded.load_checkpoint_sharded(str(work / "jax_ep2"))["state"]
    for key in ("params", "ema_params"):
        for x, y in zip(tree_leaves(blob[key]), jax.tree.leaves(getattr(jnew, key))):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert int(blob["step"]) == int(jnew.step)
