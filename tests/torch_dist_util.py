"""Workers of the multi-process tests of moldiff_tpu_torch's data, pipe,
expert, graph and model axes: each rank is a process started by
moldiff_tpu_torch.parallel.launch.spawn (gloo on the CPU, a FileStore
rendezvous). This module imports neither JAX nor the JAX package: the
spawned interpreters import it."""
import copy

import numpy as np
import torch

from moldiff_tpu_torch.models.bond_predictor import BondPredictor
from moldiff_tpu_torch.models.moldiff import MolDiff
from moldiff_tpu_torch.parallel.mesh import (Mesh, initialize_distributed, make_mesh_2d,
                                             make_mesh_3d, make_mesh_expert, make_mesh_pipe,
                                             shutdown_distributed)
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from moldiff_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _np(tree):
    return None if tree is None else tree_map(lambda x: x.detach().cpu().numpy().copy(), tree)


def make_model(kind: str, cfg: dict, kn: int, ke: int):
    cls = MolDiff if kind == "moldiff" else BondPredictor
    return cls(copy.deepcopy(cfg), kn, ke, device="cpu")


def start_state(trainer: Trainer, state: dict):
    """A trainer's state from numpy: params, step, adam count, moments, EMA."""
    st = trainer.init_from_params(params_to_torch(state["params"], "cpu"), state["step"],
                                  params_to_torch(state["ema"], "cpu")
                                  if state.get("ema") is not None else None)
    st.opt_state.count = state["count"]
    if state.get("mu") is not None:
        st.opt_state.mu = trainer.shard(params_to_torch(state["mu"], "cpu"))
    if state.get("nu") is not None:
        st.opt_state.nu = trainer.shard(params_to_torch(state["nu"], "cpu"))
    return st


def whole(trainer: Trainer, st) -> dict:
    """The whole (gathered) state as numpy."""
    full = trainer.gathered(st)
    return {"params": _np(full.params), "ema": _np(full.ema_params),
            "mu": _np(full.opt_state.mu), "nu": _np(full.opt_state.nu),
            "count": full.opt_state.count, "step": full.step}


def run_steps(trainer: Trainer, st, steps: list) -> tuple:
    """(state, [aux as floats per step], [whole state per step])."""
    auxs, states = [], []
    for batch, noise in steps:
        st, aux = trainer.train_step(st, batch, noise)
        auxs.append({k: float(v) for k, v in aux.items()})
        states.append(whole(trainer, st))
    return st, auxs, states


def train_worker(rank: int, world: int, init: str, kind: str, model_cfg: dict, kn: int,
                 ke: int, train_cfg: dict, state: dict, steps: list, eval_batch=None,
                 fsdp_modes=(False,), ckpt_dir=None):
    """Each mode of ``fsdp_modes``: the trainer at world ``world`` from
    ``state`` through ``steps`` ((global batch, noise) pairs) -> per mode
    the loss terms and whole state after each step, the shard shapes of
    params, moments and EMA, and (``eval_batch``: (batch, noise)) the eval
    terms on the final params. With ``ckpt_dir`` (FSDP mode) a sharded
    checkpoint is written before the last step, reloaded by a new trainer
    and that step taken again."""
    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        mesh = Mesh(data=world, backend="gloo").at(rank, "cpu")
        out = {}
        for fsdp in fsdp_modes:
            trainer = Trainer(make_model(kind, model_cfg, kn, ke), train_cfg, mesh=mesh,
                              fsdp=fsdp)
            st = start_state(trainer, state)
            rec = {}
            if ckpt_dir is not None and fsdp:
                st, rec["aux"], rec["states"] = run_steps(trainer, st, steps[:-1])
                trainer.save_checkpoint_sharded(ckpt_dir, st, {"model": model_cfg})
                last = run_steps(trainer, st, steps[-1:])
                back = Trainer(make_model(kind, model_cfg, kn, ke), train_cfg, mesh=mesh,
                               fsdp=fsdp)
                resumed = back.load_checkpoint(ckpt_dir, "cpu")
                again = run_steps(back, resumed, steps[-1:])
                rec["aux"] += last[1]
                rec["states"] += last[2]
                rec["resumed"] = {"aux": again[1], "states": again[2], "step": resumed.step,
                                  "count": resumed.opt_state.count}
                st = last[0]
            else:
                st, rec["aux"], rec["states"] = run_steps(trainer, st, steps)
            rec["shapes"] = {name: [tuple(x.shape) for x in tree_leaves(tree)]
                             for name, tree in (("params", st.params),
                                                ("mu", st.opt_state.mu),
                                                ("ema", st.ema_params)) if tree is not None}
            if eval_batch is not None:
                aux = trainer.eval_step(st.params, *eval_batch)
                rec["eval"] = {k: float(v) for k, v in aux.items()}
            out[fsdp] = rec
        return out
    finally:
        shutdown_distributed()


def broadcast_worker(rank: int, world: int, init: str, kind: str, model_cfg: dict, kn: int,
                     ke: int, train_cfg: dict, params: dict, perturb: bool) -> str:
    """init_from_params with rank 1's params perturbed (``perturb``) or
    not -> "ok" and rank 0's params' first leaf sum, or the error."""
    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        mesh = Mesh(data=world, backend="gloo").at(rank, "cpu")
        trainer = Trainer(make_model(kind, model_cfg, kn, ke), train_cfg, mesh=mesh)
        p = params_to_torch(params, "cpu")
        if perturb and rank == 1:
            p = tree_map(lambda x: x + 1e-3, p)
        try:
            st = trainer.init_from_params(p)
        except RuntimeError as e:
            return f"error: {e}"
        return f"ok {float(tree_leaves(st.params)[0].sum())!r}"
    finally:
        shutdown_distributed()


def save_worker(rank: int, world: int, init: str, entries_by_rank: list, path: str,
                meta: dict) -> None:
    """checkpoint_sharded.save_checkpoint_sharded of this rank's entries."""
    from moldiff_tpu_torch.train import checkpoint_sharded

    initialize_distributed(init, world, rank, backend="gloo")
    try:
        checkpoint_sharded.save_checkpoint_sharded(path, entries_by_rank[rank], rank=rank,
                                                   world=world, **meta)
    finally:
        shutdown_distributed()


def np_batch_to_torch(batch: dict) -> dict:
    out = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    out["node_type"] = out["node_type"].long()
    out["halfedge_type"] = out["halfedge_type"].long()
    return out


def ckpt_worker(rank: int, world: int, init: str, kind: str, model_cfg: dict, kn: int, ke: int,
                train_cfg: dict, state: dict, path: str, fsdp: bool) -> dict:
    """A trainer at world ``world`` (FSDP or not) from ``state`` writes a
    sharded checkpoint to ``path`` -> the whole state and its shard shapes."""
    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        mesh = Mesh(data=world, backend="gloo").at(rank, "cpu")
        trainer = Trainer(make_model(kind, model_cfg, kn, ke), train_cfg, mesh=mesh, fsdp=fsdp)
        st = start_state(trainer, state)
        st.opt_state.lr = 2.5e-5
        trainer.scheduler.step(1.0, 2.5e-5)
        trainer.save_checkpoint_sharded(path, st, {"model": model_cfg})
        out = whole(trainer, st)
        out["lr"] = st.opt_state.lr
        out["scheduler"] = trainer.scheduler.state_dict()
        return out
    finally:
        shutdown_distributed()


def mesh_of(world: int, axes: "dict | None" = None) -> Mesh:
    """The gloo mesh of ``world`` ranks: data alone, or with ``axes``
    ({"pipe": P}, {"expert": K}, {"graph": G} or {"graph": G, "model": M})
    the data axis takes the rest."""
    if not axes:
        return Mesh(data=world, backend="gloo")
    if "model" in axes:
        g, m = axes.get("graph", 1), axes["model"]
        return make_mesh_3d(world // (g * m), g, m, "cpu", "gloo")
    if "graph" in axes:
        return make_mesh_2d(world // axes["graph"], axes["graph"], "cpu", "gloo")
    (axis, size), = axes.items()
    make = make_mesh_pipe if axis == "pipe" else make_mesh_expert
    return make(world // size, size, "cpu", "gloo")


def axis_run(rank: int, world: int, kind: str, model_cfg: dict, kn: int, ke: int,
             train_cfg: dict, state: dict, steps: list, axes: "dict | None",
             ckpt_dir: "str | None" = None, read_dir: "str | None" = None,
             fsdp: bool = False, eval_batch=None, grad_check: bool = False) -> dict:
    """One trainer on ``mesh_of(world, axes)`` from ``state`` through
    ``steps`` -> the loss terms and whole state after each step, the shard
    shapes of params, moments and EMA, the step's pipeline transfers. With
    ``ckpt_dir``: a sharded directory and a pickle checkpoint
    (``<ckpt_dir>.ckpt``) written after the steps, read back by a new
    trainer, and the last step taken again from both the state and the
    directory. With ``read_dir``: the whole state read from that directory
    by a new trainer, and its shard shapes. ``fsdp``: the data axis's
    sharding; ``eval_batch`` ((batch, noise)): the eval terms on the final
    params; ``grad_check``: the whole gradient of the first step from
    ``state``."""
    mesh = mesh_of(world, axes).at(rank, "cpu")
    trainer = Trainer(make_model(kind, model_cfg, kn, ke), train_cfg, mesh=mesh, fsdp=fsdp)
    st = start_state(trainer, state)
    rec = {"pp": trainer.pp, "ep": trainer.ep, "tp": trainer.tp, "graph": trainer.graph,
           "fsdp": trainer.fsdp}
    if grad_check:
        grads = trainer.gradient(st, *steps[0])[0]
        rec["grads"] = [g.numpy() for g in tree_leaves(trainer.gather(
            tree_unflatten(st.params, grads)))]
    st, rec["aux"], rec["states"] = run_steps(trainer, st, steps)
    rec["model_comm"] = dict(trainer.model_comm)
    if eval_batch is not None:
        rec["eval"] = {k: float(v) for k, v in trainer.eval_step(st.params, *eval_batch).items()}
    rec["pipe"] = dict(trainer.pipe_stats)
    rec["shapes"] = {name: [tuple(x.shape) for x in tree_leaves(tree)]
                     for name, tree in (("params", st.params), ("mu", st.opt_state.mu),
                                        ("ema", st.ema_params)) if tree is not None}
    if ckpt_dir is not None:
        trainer.save_checkpoint_sharded(ckpt_dir, st, {"model": model_cfg})
        trainer.save_checkpoint(ckpt_dir + ".ckpt", st, {"model": model_cfg})
        rec["last"] = run_steps(trainer, st, steps[-1:])[1:]
        back = Trainer(make_model(kind, model_cfg, kn, ke), train_cfg, mesh=mesh, fsdp=fsdp)
        resumed = back.load_checkpoint(ckpt_dir, "cpu")
        rec["resumed_step"] = resumed.step
        rec["again"] = run_steps(back, resumed, steps[-1:])[1:]
    if read_dir is not None:
        other = Trainer(make_model(kind, model_cfg, kn, ke), train_cfg, mesh=mesh, fsdp=fsdp)
        got = other.load_checkpoint(read_dir, "cpu")
        rec["read"] = whole(other, got)
        rec["read_shapes"] = [tuple(x.shape) for x in tree_leaves(got.params)]
    return rec


def axis_worker(rank: int, world: int, init: str, runs: list) -> list:
    """:func:`axis_run` of each kwargs dict of ``runs``, in one process
    group of ``world`` gloo ranks."""
    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        return [axis_run(rank, world, **kw) for kw in runs]
    finally:
        shutdown_distributed()


def pipe_forward_worker(rank: int, world: int, init: str, n_pipe: int, params: dict,
                        static_cfg: dict, inputs: list, cases: list) -> list:
    """pipeline_denoiser on ``mesh_of(world, {"pipe": n_pipe})``: per case
    (num_microbatches, update_pos, with_grads) this rank's outputs of its
    data shard's rows from its stage's blocks and, with_grads, the
    gradients of the sum of its outputs with respect to the whole block
    leaves (zero outside the stage's blocks)."""
    from moldiff_tpu_torch.models.denoiser import denoiser_static_config
    from moldiff_tpu_torch.parallel.pipeline import pipeline_denoiser

    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        mesh = mesh_of(world, {"pipe": n_pipe}).at(rank, "cpu")
        out = []
        for n_micro, update_pos, with_grads in cases:
            static = denoiser_static_config(**static_cfg, update_pos=update_pos)
            tree = params_to_torch(params[update_pos], "cpu")
            leaves = [x.requires_grad_(with_grads) for x in tree_leaves(tree)]
            b = inputs[0].shape[0] // mesh.data
            rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
            k = static["num_blocks"] // n_pipe
            s = mesh.axis_rank
            with torch.set_grad_enabled(with_grads):
                stage = {"blocks": tree_map(lambda x: x[s * k:(s + 1) * k], tree["blocks"])}
                res = pipeline_denoiser(stage, static, *(torch.tensor(x[rows]) for x in inputs),
                                        mesh=mesh, num_microbatches=n_micro)
            rec = {"out": [x.detach().numpy() for x in res]}
            if with_grads:
                grads = torch.autograd.grad(sum(x.sum() for x in res), leaves)
                rec["grads"] = [g.numpy() for g in grads]
            out.append(rec)
        return out
    finally:
        shutdown_distributed()


def graph_forward_worker(rank: int, world: int, init: str, n_graph: int, params: dict,
                         static_cfg: dict, cases: list) -> list:
    """node_edge_net by the row-split route on ``mesh_of(world, {"graph":
    n_graph})``: per case (inputs, output weights) -> this rank's outputs
    on its data shard's rows, and the gradients of the sum of its outputs
    times the weights with respect to the whole block leaves and to its
    rows of the inputs h_node, pos, h_edge."""
    from moldiff_tpu_torch.models.denoiser import denoiser_static_config, node_edge_net
    from moldiff_tpu_torch.parallel.mesh import pair_sharding

    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        mesh = mesh_of(world, {"graph": n_graph}).at(rank, "cpu")
        ps = pair_sharding(mesh)
        static = denoiser_static_config(**static_cfg)
        out = []
        for inputs, weights in cases:
            tree = params_to_torch(params, "cpu")
            leaves = [x.requires_grad_(True) for x in tree_leaves(tree)]
            b = inputs[0].shape[0] // mesh.data
            rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
            x = [torch.tensor(v[rows]) for v in inputs]
            ins = [t.requires_grad_(True) for t in x[:3]]
            res = node_edge_net(tree, static, *ins, *x[3:], pair_sharding=ps)
            loss = sum((r * torch.tensor(w[rows])).sum() for r, w in zip(res, weights))
            grads = torch.autograd.grad(loss, leaves + ins)
            out.append({"out": [r.detach().numpy() for r in res],
                        "grads": [g.numpy() for g in grads[:len(leaves)]],
                        "input_grads": [g.numpy() for g in grads[len(leaves):]]})
        return out
    finally:
        shutdown_distributed()


def tp_forward(rank: int, world: int, axes: dict, params: dict, static_cfg: dict,
               inputs: list, weights: list) -> dict:
    """node_edge_net by the row-split route on ``mesh_of(world, axes)`` (a
    graph and a model axis), each rank holding its tp_param_sharding
    shards of ``params`` (split MLPs marked, as the trainer holds them) ->
    this rank's outputs on its data shard's rows (the load-balance loss
    last under ``moe``), and the gradients of the sum of its outputs times
    ``weights`` with respect to the whole block leaves (gathered from the
    shards) and to its rows of h_node, pos, h_edge. ``inputs``: h_node,
    pos, h_edge, node_time, edge_time, pair_mask, node_mask."""
    from moldiff_tpu_torch.models.denoiser import denoiser_static_config, node_edge_net
    from moldiff_tpu_torch.models.nn import mark_tp
    from moldiff_tpu_torch.parallel.mesh import all_gather_axis, pair_sharding, tp_param_sharding

    mesh = mesh_of(world, axes).at(rank, "cpu")
    ps = pair_sharding(mesh)
    static = denoiser_static_config(**static_cfg)
    whole_tree = params_to_torch(params, "cpu")
    place_tree = tp_param_sharding(mesh, whole_tree)
    places = tree_leaves(place_tree)
    shards = [p.take(x, mesh.coord(p.axis)).requires_grad_(True)
              for p, x in zip(places, tree_leaves(whole_tree))]
    tree = mark_tp(tree_unflatten(whole_tree, shards), place_tree)
    b = inputs[0].shape[0] // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    x = [torch.tensor(v[rows]) for v in inputs]
    ins = [t.requires_grad_(True) for t in x[:3]]
    res = node_edge_net(tree, static, *ins, *x[3:6], node_mask=x[6], pair_sharding=ps)
    loss = sum((r * torch.tensor(w[rows] if np.ndim(w) else w)).sum()
               for r, w in zip(res, weights))
    grads = torch.autograd.grad(loss, shards + ins)
    whole_grads = all_gather_axis(mesh, places, list(grads[:len(shards)]))
    return {"out": [r.detach().numpy() for r in res],
            "grads": [g.numpy() for g in whole_grads],
            "input_grads": [g.numpy() for g in grads[len(shards):]],
            "split": sum(p.dim is not None for p in places)}


def forward_and_axis_worker(rank: int, world: int, init: str, forward: "dict | None",
                            runs: list) -> dict:
    """:func:`tp_forward` of the kwargs ``forward`` (when given), then
    :func:`axis_run` of each kwargs dict of ``runs``, in one process group
    of ``world`` gloo ranks."""
    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        out = {"forward": tp_forward(rank, world, **forward) if forward else None}
        out["runs"] = [axis_run(rank, world, **kw) for kw in runs]
        return out
    finally:
        shutdown_distributed()
