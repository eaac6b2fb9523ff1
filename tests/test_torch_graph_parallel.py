"""moldiff_tpu_torch's graph axis (the pair tensors split by receiver, JAX's
plain route with its collectives written out; models/denoiser.py
node_edge_net_sharded, one gloo process per rank) against moldiff_tpu
under pair_sharding on JAX's (data, graph) meshes of the conftest's
virtual CPU devices, with tests/torch_axes_util.py's tiny two-block model
at float32:

- node_edge_net on make_mesh_2d(1, 2) at N = 8 and on (2, 2) at N = 7
  (padded with masked receiver rows), at JAX's rtol 2e-5 / atol 2e-6; the
  gradients of a weighted sum of its outputs with respect to the block
  params (each scaled by its leaf's largest, atol 3e-5) and to the inputs;
- a train step at (data 2, graph 2) with grad_accum 2 on an odd batch (the
  clip active), fed JAX's noise, against JAX's Trainer on that mesh
  (params rtol 2e-5 / atol 2e-6), every rank's whole state bit-equal, and
  the eval terms after it; the same step under FSDP beside graph; the
  bond predictor's step on the graph axis;
- the plain gated route at world 1 (make_mesh_2d(1, 1), no process group)
  against JAX's Trainer on make_mesh_2d(1, 1), with no kernel wrapper
  called. MoE beside the graph and model axes and FSDP beside a pipe axis
  without a pipeline: tests/test_torch_moe_axes.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moldiff_tpu.models.denoiser import init_node_edge_net as j_init_net
from moldiff_tpu.models.denoiser import node_edge_net as j_node_edge_net
from moldiff_tpu.parallel import mesh as jmesh
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu_torch.parallel import launch
from moldiff_tpu_torch.parallel.mesh import make_mesh_2d
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.tree import tree_leaves
from test_torch_data_parallel import (assert_aux_close, assert_state_close, batch,
                                      eval_noise, jax_state, train_cfg)
from torch_axes_util import (SPAWN_S, T_MAX, NoKernels, background, jax_model, mid_run,
                             model_cfg, noise, padded, run_kwargs, world_one)
from torch_dist_util import axis_worker, graph_forward_worker, make_model, np_batch_to_torch, \
    start_state
from torch_port_util import np_tree

NET = {"num_blocks": 2, "cutoff": 10.0, "use_gate": True}
# (mesh, N): N = 7 does not divide by the graph axis (padded receiver rows)
CASES = [((1, 2), 8), ((2, 2), 7)]


def _inputs(n: int, b: int = 8) -> tuple:
    """Denoiser inputs (tiny widths, node 16 / edge 8) and the weights of
    the summed outputs."""
    rng = np.random.default_rng(n)
    h_node = rng.normal(size=(b, n, 16)).astype(np.float32)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32)
    h_edge = rng.normal(size=(b, n, n, 8)).astype(np.float32)
    t = rng.random((b, 1, 1)).astype(np.float32)
    node_mask = (rng.random((b, n)) > 0.2).astype(np.float32)
    pm = node_mask[:, :, None] * node_mask[:, None, :] * (1.0 - np.eye(n, dtype=np.float32))
    weights = [rng.normal(size=x.shape).astype(np.float32) for x in (h_node, pos, h_edge)]
    return [h_node, pos, h_edge, t, t * 0.5, pm], weights


@pytest.fixture(scope="module")
def forward_runs():
    """The port's row-split node_edge_net in each case (spawned at once)
    and JAX's under pair_sharding on the same mesh."""
    jp, static = j_init_net(jax.random.key(0), 16, 8, **NET)
    params = np_tree(jp)
    futures = {case: background(launch.spawn, graph_forward_worker, case[0][0] * case[0][1],
                                args=(case[0][1], params, NET, [_inputs(case[1])]),
                                timeout_s=SPAWN_S) for case in CASES}
    want = {}
    for mesh, n in CASES:
        inputs, weights = _inputs(n)
        ps = jmesh.pair_sharding(jmesh.make_mesh_2d(*mesh))
        rest = [jnp.asarray(x) for x in inputs[3:]]

        def fn(p, h, pos, e):
            out = j_node_edge_net(p, static, h, pos, e, *rest, remat=False, pair_sharding=ps)
            return sum(jnp.sum(o * w) for o, w in zip(out, weights)), out

        (_, out), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2, 3), has_aux=True))(
            jp, *(jnp.asarray(x) for x in inputs[:3]))
        want[(mesh, n)] = {"out": [np.asarray(x) for x in out],
                           "grads": [np.asarray(x) for x in jax.tree.leaves(grads[0])],
                           "input_grads": [np.asarray(x) for x in grads[1:]]}
    return {"want": want, "got": {case: [r[0] for r in f.result()]
                                  for case, f in futures.items()}}


@pytest.mark.parametrize("mesh,n", CASES)
def test_node_edge_net_equals_jax(forward_runs, mesh, n):
    """Each rank's outputs and input gradients are JAX's rows of its data
    shard, on every graph rank (replicated over graph)."""
    n_data, n_graph = mesh
    want = forward_runs["want"][(mesh, n)]
    for rank, rec in enumerate(forward_runs["got"][(mesh, n)]):
        b = want["out"][0].shape[0] // n_data
        rows = slice((rank // n_graph) * b, (rank // n_graph + 1) * b)
        for x, w in zip(rec["out"], want["out"]):
            np.testing.assert_allclose(x, w[rows], rtol=2e-5, atol=2e-6,
                                       err_msg=f"{mesh} N={n} rank {rank}")
        for g, w in zip(rec["input_grads"], want["input_grads"]):
            scale = max(1e-6, float(np.abs(w).max()))
            np.testing.assert_allclose(g / scale, w[rows] / scale, atol=3e-5)


@pytest.mark.parametrize("mesh,n", CASES)
def test_node_edge_net_gradients_equal_jax(forward_runs, mesh, n):
    """The block params' gradients are whole and equal on every graph rank
    (the rule of models/denoiser.py); summed over the data coordinates
    they are jax.grad's."""
    n_data, n_graph = mesh
    want = forward_runs["want"][(mesh, n)]["grads"]
    ranks = [r["grads"] for r in forward_runs["got"][(mesh, n)]]
    for d in range(n_data):
        for g in range(1, n_graph):
            for x, y in zip(ranks[d * n_graph + g], ranks[d * n_graph]):
                np.testing.assert_array_equal(x, y)
    total = [sum(ranks[d * n_graph][i] for d in range(n_data)) for i in range(len(want))]
    for g, w in zip(total, want):
        scale = max(1e-6, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, atol=3e-5)


# -- training on the (data 2, graph 2) mesh ---------------------------------------

@pytest.fixture(scope="module")
def graph_train():
    """A step of grad_accum 2 at (data 2, graph 2) on B = 5 (padded to 8),
    the clip active, and the eval terms after it; the same step under
    FSDP; the bond predictor's step on the same mesh; all four ranks in one
    process group. JAX: its Trainer on make_mesh_2d(2, 2) for each."""
    params = np_tree(jax_model().init_params(jax.random.key(0)))
    tcfg = train_cfg(grad_accum=2, max_grad_norm=1.0)
    b = batch(5, seed=3)
    state = mid_run("moldiff", params, tcfg, b)
    key, ekey = jax.random.key(21), jax.random.key(5)
    steps = [(np_batch_to_torch(b), noise("moldiff", key, 8, 2))]
    evals = (np_batch_to_torch(b), eval_noise("moldiff", ekey, 8, T_MAX["moldiff"]))
    bparams = np_tree(jax_model("bond").init_params(jax.random.key(0)))
    bcfg = train_cfg("bond")
    bb = batch(4, seed=4, kind="bond")
    bstate = mid_run("bond", bparams, bcfg, bb)
    bsteps = [(np_batch_to_torch(bb), noise("bond", jax.random.key(17), 4))]
    axes = {"graph": 2}
    runs = [run_kwargs("moldiff", tcfg, state, steps, axes, eval_batch=evals),
            run_kwargs("moldiff", tcfg, state, steps, axes, fsdp=True),
            run_kwargs("bond", bcfg, bstate, bsteps, axes)]
    future = background(launch.spawn, axis_worker, 4, args=(runs,), timeout_s=SPAWN_S)

    jm = jmesh.make_mesh_2d(2, 2)
    out = {}
    for name, fsdp in (("jax", False), ("jax_fsdp", True)):
        jt = JTrainer(jax_model(), tcfg, mesh=jm, fsdp=fsdp)
        assert jt.fsdp == fsdp and not jt.tp
        out[name] = jt.train_step(jax_state(jt, state), b, key)
        if not fsdp:
            out["jax_eval"] = jt.eval_step(out[name][0].params, b, ekey)
    bt = JTrainer(jax_model("bond"), bcfg, mesh=jm)
    out["bond_jax"] = bt.train_step(jax_state(bt, bstate), bb, jax.random.key(17))
    out["one"] = world_one("moldiff", tcfg, state,
                           [(np_batch_to_torch(padded(b, 8)), steps[0][1])])
    out["bond_one"] = world_one("bond", bcfg, bstate, bsteps)
    out["ranks"] = future.result()
    return out


def test_graph_train_step_equals_jax(graph_train):
    """Loss terms and the whole state after the step against JAX's Trainer
    on make_mesh_2d(2, 2): the gradients summed over data alone."""
    jst, jaux = graph_train["jax"]
    assert float(jaux["grad_norm"]) > 1.0
    for r, ranks in enumerate(graph_train["ranks"]):
        rec = ranks[0]
        assert rec["graph"] and not rec["tp"] and not rec["fsdp"]
        assert_aux_close(rec["aux"][0], jaux, graph_train["one"][0][0])
        assert_state_close(rec["states"][-1], jst, f"graph 2 rank {r}")
        assert rec["states"][-1]["step"] == int(jst.step)
        comm = rec["model_comm"]
        assert comm["all_gather_calls"] > 0 and comm["reduce_scatter_calls"] > 0
        assert comm["all_reduce_calls"] > 0


def test_graph_ranks_hold_equal_whole_states(graph_train):
    """Adam and the EMA give every rank the same whole state, bit for bit."""
    ranks = [r[0] for r in graph_train["ranks"]]
    for rec in ranks[1:]:
        for name in ("params", "ema", "mu", "nu"):
            for x, y in zip(tree_leaves(rec["states"][-1][name]),
                            tree_leaves(ranks[0]["states"][-1][name])):
                np.testing.assert_array_equal(x, y)


def test_graph_eval_step_equals_jax(graph_train):
    want = graph_train["jax_eval"]
    for rec in (r[0] for r in graph_train["ranks"]):
        for k, v in want.items():
            assert rec["eval"][k] == pytest.approx(float(v), rel=1e-5, abs=1e-6), k


def test_fsdp_beside_graph_equals_jax(graph_train):
    """FSDP on the data axis beside graph (allowed, as in JAX): the step
    equals JAX's Trainer(fsdp=True) on the mesh; each rank holds its data
    coordinate's FSDP shards."""
    jst, jaux = graph_train["jax_fsdp"]
    for r, ranks in enumerate(graph_train["ranks"]):
        rec = ranks[1]
        assert rec["fsdp"] and rec["graph"]
        assert_aux_close(rec["aux"][0], jaux, graph_train["one"][0][0])
        assert_state_close(rec["states"][-1], jst, f"FSDP beside graph rank {r}")
        full = [x.shape for x in tree_leaves(rec["states"][-1]["params"])]
        assert rec["shapes"]["params"] != full
        assert rec["shapes"]["params"] == graph_train["ranks"][r // 2 * 2][1]["shapes"]["params"]


def test_graph_bond_predictor_step_equals_jax(graph_train):
    """The bond predictor (update_pos false, the distances once) takes the
    same route: its step equals JAX's on the graph mesh."""
    bnew, baux = graph_train["bond_jax"]
    for r, ranks in enumerate(graph_train["ranks"]):
        rec = ranks[2]
        assert rec["graph"]
        assert_aux_close(rec["aux"][0], baux, graph_train["bond_one"][0][0])
        assert_state_close(rec["states"][0], bnew, f"bond rank {r}")


def test_plain_route_world_one_equals_jax(monkeypatch):
    """make_mesh_2d(1, 1) without a process group: the plain gated route on
    one rank, no kernel wrapper called, against JAX's Trainer on
    make_mesh_2d(1, 1) (pair_sharding set, its Pallas route off)."""
    params = np_tree(jax_model().init_params(jax.random.key(1)))
    tcfg = train_cfg(max_grad_norm=1.0)
    b = batch(4, seed=5)
    state = mid_run("moldiff", params, tcfg, b)
    key = jax.random.key(8)
    jt = JTrainer(jax_model(), tcfg, mesh=jmesh.make_mesh_2d(1, 1))
    assert jt.model.pair_sharding is not None
    jst, jaux = jt.train_step(jax_state(jt, state), b, key)
    spy = NoKernels(monkeypatch)
    mesh = make_mesh_2d(1, 1, "cpu")
    tr = Trainer(make_model("moldiff", model_cfg(), 8, 6), tcfg, mesh=mesh)
    assert tr.mesh is None and tr.graph and tr.model.pair_sharding.graph.size == 1
    st, aux = tr.train_step(start_state(tr, state), np_batch_to_torch(b),
                            noise("moldiff", key, 4))
    assert spy.calls == []
    for k, v in jaux.items():
        assert float(aux[k]) == pytest.approx(float(v), rel=2e-5, abs=2e-6), k
    got = {"params": np_tree(st.params), "ema": np_tree(st.ema_params)}
    assert_state_close(got, jst, "world 1 plain route")
