"""moldiff_tpu_torch's pipe axis (parallel/pipeline.py, one gloo process per
rank) against moldiff_tpu's GPipe executor and Trainer on JAX's (data,
pipe) meshes of the conftest's virtual CPU devices:

- pipeline_denoiser on make_mesh_pipe(1, 2) and (2, 2), 4 blocks,
  microbatches None, 1 and 4 and update_pos false, at JAX's rtol 2e-5 /
  atol 2e-6; the gradients of the sum of its outputs (each scaled by its
  leaf's largest, atol 3e-5);
- a train step at (data 2, pipe 2) with grad_accum 2 on an odd batch
  (the clip active) against JAX's Trainer on that mesh, fed JAX's noise
  (params rtol 2e-5 / atol 2e-6), every rank's whole state bit-equal;
- pipe_param_sharding leaf by leaf against JAX's specs; the microbatch
  choice; MoE and an indivisible block count refused as JAX refuses them;
- sharded checkpoints: a PP2 directory read at world 1, a world-1 one read
  by the PP2 ranks, a resume round trip, the params' leaf files named as
  JAX's, and JAX's own pipe directory read into the port;
- the bond predictor (no pipeline in JAX either) on the pipe mesh.

The spawned ranks run in a thread while JAX computes its side."""
import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_node_edge_net as j_init_net
from moldiff_tpu.parallel import pipeline as jpipe
from moldiff_tpu.train.checkpoint_sharded import save_checkpoint_sharded as j_save_sharded
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu_torch.models.denoiser import denoiser_static_config
from moldiff_tpu_torch.parallel import launch, pipeline
from moldiff_tpu_torch.parallel.mesh import make_mesh_pipe
from moldiff_tpu_torch.train import checkpoint_sharded
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy
from moldiff_tpu_torch.utils.tree import tree_leaves
from test_torch_data_parallel import (TYPES, assert_aux_close, assert_state_close, batch,
                                      jax_model, jax_state, mid_run, model_cfg, step_noise,
                                      train_cfg, world_one)
from torch_dist_util import (axis_worker, make_model, np_batch_to_torch, pipe_forward_worker,
                             start_state)
from torch_port_util import np_tree

SPAWN_S = 240
NET = {"num_blocks": 4, "cutoff": 10.0, "use_gate": True}
# (num_microbatches, update_pos, with gradients) per mesh
CASES = {(1, 2): [(None, True, False), (1, True, False), (4, True, True), (None, False, False)],
         (2, 2): [(None, True, True), (1, True, False), (4, True, False)]}


def _inputs(b: int = 8, n: int = 6) -> list:
    """tests/test_pipeline_parallel.py's denoiser inputs."""
    rng = np.random.default_rng(0)
    h_node = rng.normal(size=(b, n, 32)).astype(np.float32)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32)
    h_edge = rng.normal(size=(b, n, n, 16)).astype(np.float32)
    t = np.full((b, 1, 1), 0.3, np.float32)
    node_mask = (rng.random((b, n)) > 0.2).astype(np.float32)
    pm = node_mask[:, :, None] * node_mask[:, None, :] * (1.0 - np.eye(n, dtype=np.float32))
    return [h_node, pos, h_edge, t, t, pm]


def _background(fn, *args, **kw):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kw)
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def forward_runs():
    """The port's pipeline_denoiser at (1, 2) and (2, 2) (both spawned at
    once) and JAX's on the same meshes, per case."""
    params = {u: np_tree(j_init_net(jax.random.key(0), 32, 16, update_pos=u, **NET)[0])
              for u in (True, False)}
    inputs = _inputs()
    futures = {mesh: _background(launch.spawn, pipe_forward_worker, mesh[0] * mesh[1],
                                 args=(mesh[1], params, NET, inputs, CASES[mesh]),
                                 timeout_s=SPAWN_S) for mesh in CASES}
    jin = [jnp.asarray(x) for x in inputs]
    want = {}
    for mesh, cases in CASES.items():
        jm = jpipe.make_mesh_pipe(*mesh)
        for n_micro, update_pos, with_grads in cases:
            static = j_init_net(jax.random.key(0), 32, 16, update_pos=update_pos, **NET)[1]
            fn = lambda p, *a: jpipe.pipeline_denoiser(p, static, *a, mesh=jm,
                                                       num_microbatches=n_micro, remat=False)
            jp = jax.tree.map(jnp.asarray, params[update_pos])
            rec = {"out": [np.asarray(x) for x in jax.jit(fn)(jp, *jin)]}
            if with_grads:
                g = jax.jit(jax.grad(lambda p: sum(jnp.sum(x) for x in fn(p, *jin))))(jp)
                rec["grads"] = [np.asarray(x) for x in jax.tree.leaves(g)]
            want[(mesh, n_micro, update_pos)] = rec
    return {"want": want, "got": {mesh: f.result() for mesh, f in futures.items()}}


@pytest.mark.parametrize("mesh", list(CASES))
def test_pipeline_denoiser_equals_jax(forward_runs, mesh):
    """Each rank's outputs are JAX's rows of its data shard, on every
    stage (the output is replicated over pipe)."""
    n_data, n_pipe = mesh
    for c, (n_micro, update_pos, _) in enumerate(CASES[mesh]):
        want = forward_runs["want"][(mesh, n_micro, update_pos)]["out"]
        for rank, got in enumerate(forward_runs["got"][mesh]):
            b = want[0].shape[0] // n_data
            rows = slice((rank // n_pipe) * b, (rank // n_pipe + 1) * b)
            for x, w in zip(got[c]["out"], want):
                np.testing.assert_allclose(x, w[rows], rtol=2e-5, atol=2e-6,
                                           err_msg=f"{mesh} M={n_micro} rank {rank}")


@pytest.mark.parametrize("mesh", list(CASES))
def test_pipeline_gradients_equal_jax(forward_runs, mesh):
    """The gradients of the sum of the outputs: each rank's are its stage's
    blocks on its data shard's rows (zero elsewhere), summed over the ranks
    once, against jax.grad of JAX's pipeline."""
    for c, (n_micro, update_pos, with_grads) in enumerate(CASES[mesh]):
        if not with_grads:
            continue
        want = forward_runs["want"][(mesh, n_micro, update_pos)]["grads"]
        ranks = forward_runs["got"][mesh]
        stage_k = NET["num_blocks"] // mesh[1]
        for rank, r in enumerate(ranks):
            s = rank % mesh[1]
            for g in r[c]["grads"]:
                assert not g[:s * stage_k].any() and not g[(s + 1) * stage_k:].any()
        total = [sum(r[c]["grads"][i] for r in ranks) for i in range(len(want))]
        for g, w in zip(total, want):
            scale = max(1e-6, float(np.abs(w).max()))
            np.testing.assert_allclose(g / scale, w / scale, atol=3e-5)


@pytest.mark.parametrize("ckpt,n_pipe", [("ckpts/flagship_v2.ckpt", 2),
                                         ("ckpts/flagship_v2.ckpt", 4),
                                         ("ckpts/bondpred_v2.ckpt", 4)])
def test_pipe_param_sharding_equals_jax(ckpt, n_pipe):
    """Each leaf's split dimension, shard shape and every rank's slice
    equal JAX's NamedSharding on a (2, P) pipe mesh (6 blocks over 4
    stages: replicated, as in JAX)."""
    params = load_checkpoint_numpy(ckpt)["params"]
    jm = jpipe.make_mesh_pipe(2, n_pipe)
    want = jax.tree.leaves(jpipe.pipe_param_sharding(jm, params))
    got = tree_leaves(pipeline.pipe_param_sharding(make_mesh_pipe(2, n_pipe), params))
    leaves = jax.tree.leaves(params)
    assert len(got) == len(want) == len(leaves)
    for x, p, s in zip(leaves, got, want):
        spec = tuple(s.spec) + (None,) * (x.ndim - len(s.spec))
        assert p.dim == next((d for d, a in enumerate(spec) if a == jpipe.PIPE_AXIS), None)
        assert p.shard_shape == tuple(s.shard_shape(x.shape))
        index = s.devices_indices_map(x.shape)
        for (d, q), dev in np.ndenumerate(jm.devices):
            np.testing.assert_array_equal(x[p.index(q)], x[index[dev]])
    blocks = next(v["blocks"] for v in params.values() if isinstance(v, dict) and "blocks" in v)
    assert any(p.dim == 0 for p in got) == (tree_leaves(blocks)[0].shape[0] % n_pipe == 0)


@pytest.mark.parametrize("b,req,p", [(8, None, 2), (8, 3, 2), (6, 4, 2), (1, 4, 4), (12, 5, 3)])
def test_choose_microbatches_equals_jax(b, req, p):
    assert pipeline._choose_microbatches(b, req, p) == jpipe._choose_microbatches(b, req, p)


def test_moe_and_indivisible_blocks_refused_as_jax():
    """A MoE denoiser raises JAX's ValueError ("MoE"); num_blocks not
    divisible by pipe fails JAX's assert, before any collective."""
    moe = {"num_experts": 2, "top_k": 1}
    jp, jstatic = j_init_net(jax.random.key(0), 32, 16, moe=moe, **NET)
    inputs = _inputs()
    with pytest.raises(ValueError, match="MoE") as want:
        jpipe.pipeline_denoiser(jp, jstatic, *map(jnp.asarray, inputs),
                                mesh=jpipe.make_mesh_pipe(1, 2))
    tp = {"blocks": {"w": torch.zeros(2, 2)}}
    t_in = [torch.tensor(x) for x in inputs]
    with pytest.raises(ValueError, match="MoE") as got:
        pipeline.pipeline_denoiser(tp, denoiser_static_config(moe=moe, **NET), *t_in,
                                   mesh=make_mesh_pipe(1, 2))
    assert str(got.value) == str(want.value)
    jp, jstatic = j_init_net(jax.random.key(0), 32, 16, **NET)
    with pytest.raises(AssertionError) as want:
        jpipe.pipeline_denoiser(jp, jstatic, *map(jnp.asarray, inputs),
                                mesh=jpipe.make_mesh_pipe(1, 3))
    with pytest.raises(AssertionError) as got:
        pipeline.pipeline_denoiser(tp, denoiser_static_config(**NET), *t_in,
                                   mesh=make_mesh_pipe(1, 3))
    assert str(got.value) == str(want.value)


# -- training on the (data 2, pipe 2) mesh ----------------------------------------

@pytest.fixture(scope="module")
def pp_train(tmp_path_factory):
    """A step of grad_accum 2 at (data 2, pipe 2) on B = 5 (padded to 8), a
    PP2 directory and pickle written after it, the step taken again from
    the state and from the directory read back; a world-1 directory
    read by the PP2 ranks; the bond predictor's step on the same mesh. JAX:
    its Trainer on make_mesh_pipe(2, 2), and its directory of the state."""
    work = tmp_path_factory.mktemp("pp")
    params = np_tree(jax_model("moldiff").init_params(jax.random.key(0)))
    tcfg = train_cfg(grad_accum=2, max_grad_norm=1.0)
    batches = [batch(5, seed=3)]
    state = mid_run("moldiff", params, tcfg, batches[0])
    keys = [jax.random.key(21)]
    steps = [(np_batch_to_torch(b), step_noise("moldiff", k, 8, 2, 1000))
             for b, k in zip(batches, keys)]
    # a world-1 directory of the mid-run state
    kn, ke = TYPES["moldiff"]
    one = Trainer(make_model("moldiff", model_cfg(), kn, ke), tcfg)
    one.save_checkpoint_sharded(str(work / "w1"), start_state(one, state), {"model": model_cfg()})

    bparams = np_tree(jax_model("bond").init_params(jax.random.key(0)))
    bcfg = train_cfg("bond")
    bb = batch(4, seed=4, kind="bond")
    bstate = mid_run("bond", bparams, bcfg, bb)
    bsteps = [(np_batch_to_torch(bb), step_noise("bond", jax.random.key(17), 4, 1, 200))]
    runs = [dict(kind="moldiff", model_cfg=model_cfg(), kn=kn, ke=ke, train_cfg=tcfg,
                 state=state, steps=steps, axes={"pipe": 2}, ckpt_dir=str(work / "pp2"),
                 read_dir=str(work / "w1")),
            dict(kind="bond", model_cfg=model_cfg("bond"), kn=TYPES["bond"][0],
                 ke=TYPES["bond"][1], train_cfg=bcfg, state=bstate, steps=bsteps,
                 axes={"pipe": 2})]
    future = _background(launch.spawn, axis_worker, 4, args=(runs,), timeout_s=SPAWN_S)

    jm = jpipe.make_mesh_pipe(2, 2)
    jt = JTrainer(jax_model("moldiff"), tcfg, mesh=jm)
    assert jt.pp
    jst, jaux = jax_state(jt, state), []
    for b, k in zip(batches, keys):
        jst, a = jt.train_step(jst, b, k)
        jaux.append(a)
    j_save_sharded(str(work / "jax_pp2"), jst)
    bt = JTrainer(jax_model("bond"), bcfg, mesh=jm)
    assert not bt.pp
    bnew, baux = bt.train_step(jax_state(bt, bstate), bb, jax.random.key(17))
    padded = [{k: np.concatenate([v, np.zeros((3,) + v.shape[1:], v.dtype)])
               for k, v in b.items()} for b in batches]
    return {"work": work, "state": state, "jax": (jst, jaux), "bond_jax": (bnew, baux),
            "one": world_one("moldiff", tcfg, state,
                             [(np_batch_to_torch(p), nz) for p, (_, nz) in zip(padded, steps)]),
            "bond_one": world_one("bond", bcfg, bstate, bsteps), "ranks": future.result()}


def test_pp_train_steps_equal_jax(pp_train):
    """Loss terms and the whole state after the step against JAX's Trainer
    on the pipe mesh: the pipe ranks' gradients counted once."""
    jst, jaux = pp_train["jax"]
    assert float(jaux[0]["grad_norm"]) > 1.0
    for r, ranks in enumerate(pp_train["ranks"]):
        rec = ranks[0]
        assert rec["pp"] and not rec["ep"]
        for got, want, one in zip(rec["aux"], jaux, pp_train["one"][0]):
            assert_aux_close(got, want, one)
        assert_state_close(rec["states"][-1], jst, f"PP2 rank {r}")
        assert rec["states"][-1]["step"] == int(jst.step)
        assert rec["pipe"]["p2p_bytes"] > 0


def test_pp_ranks_hold_equal_whole_states(pp_train):
    """Adam and the EMA give every rank the same whole state, bit for bit;
    each rank holds its stage's blocks (half of each stacked leaf)."""
    ranks = [r[0] for r in pp_train["ranks"]]
    for rec in ranks[1:]:
        for name in ("params", "ema", "mu", "nu"):
            for x, y in zip(tree_leaves(rec["states"][-1][name]),
                            tree_leaves(ranks[0]["states"][-1][name])):
                np.testing.assert_array_equal(x, y)
    full = [x.shape for x in tree_leaves(ranks[0]["states"][-1]["params"])]
    paths = [p for p, _ in checkpoint_sharded.key_paths(ranks[0]["states"][-1]["params"])]
    for p, shape, got in zip(paths, full, ranks[0]["shapes"]["params"]):
        want = (shape[0] // 2,) + shape[1:] if "blocks" in p else shape
        assert got == want, (p, got)
    assert ranks[0]["shapes"]["mu"] == ranks[0]["shapes"]["ema"] == ranks[0]["shapes"]["params"]


def test_pp_sharded_checkpoint_round_trips(pp_train):
    """The PP2 directory and pickle read at world 1 hold the whole state;
    a step from the directory read back on the pipe mesh is bit-equal to
    the same step from the state; a world-1 directory read by the
    PP2 ranks gives them the whole mid-run state, in stage shards."""
    work, rec = pp_train["work"], pp_train["ranks"][0][0]
    full = checkpoint_sharded.load_checkpoint_sharded(str(work / "pp2"))["state"]
    pickled = load_checkpoint_numpy(str(work / "pp2.ckpt"))
    for name, key in (("params", "params"), ("ema", "ema_params")):
        for x, y, z in zip(tree_leaves(full[key]), tree_leaves(rec["states"][-1][name]),
                           tree_leaves(pickled[key])):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(z, y)
    assert int(full["step"]) == rec["states"][-1]["step"] == rec["resumed_step"]
    (aux_a, st_a), (aux_b, st_b) = rec["last"], rec["again"]
    assert aux_a == aux_b
    for name in ("params", "ema", "mu"):
        for x, y in zip(tree_leaves(st_a[0][name]), tree_leaves(st_b[0][name])):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(tree_leaves(rec["read"]["params"]),
                    tree_leaves(pp_train["state"]["params"])):
        np.testing.assert_array_equal(x, y)
    assert rec["read_shapes"] == rec["shapes"]["params"]


def test_pp_leaf_files_equal_jax_and_jax_directory_reads(pp_train):
    """The params' shard files of the PP2 directory are named as JAX's
    directory of the same placement names them; JAX's directory reads into
    the port: params, EMA and step."""
    work = pp_train["work"]
    jst, _ = pp_train["jax"]
    n = len(jax.tree.leaves(jst.params))
    names = lambda d: sorted(f for f in os.listdir(d) if f.startswith("leaf")
                             and int(f[4:].split("_")[0]) < n)
    assert names(work / "pp2") == names(work / "jax_pp2")
    blob = checkpoint_sharded.load_checkpoint_sharded(str(work / "jax_pp2"))["state"]
    for key in ("params", "ema_params"):
        for x, y in zip(tree_leaves(blob[key]), jax.tree.leaves(getattr(jst, key))):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert int(blob["step"]) == int(jst.step)


def test_pp_bond_predictor_trains_with_pipe_replicas(pp_train):
    """The bond predictor has no pipeline (JAX: Trainer.pp false): the pipe
    ranks are replicas, and the step equals JAX's on the pipe mesh."""
    bnew, baux = pp_train["bond_jax"]
    for r, ranks in enumerate(pp_train["ranks"]):
        rec = ranks[1]
        assert not rec["pp"] and rec["shapes"]["params"] == [
            x.shape for x in tree_leaves(rec["states"][0]["params"])]
        assert_aux_close(rec["aux"][0], baux, pp_train["bond_one"][0][0])
        assert_state_close(rec["states"][0], bnew, f"bond rank {r}")
