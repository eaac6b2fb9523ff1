"""Train and eval steps, EMA and checkpoints (moldiff_tpu/train/trainer.py).

One training step is the JAX package's ``jax.value_and_grad(loss_fn)`` +
optax update + EMA, on one card: the position jitter of
``pos_noise_std``, the model's ``get_loss`` through the kernels (forward
and backward), the global gradient norm before clipping, the optimizer of
train/optim.py, then ``ema <- decay * ema + (1 - decay) * params``. The
model is MolDiff or the BondPredictor: anything with ``init_params``,
``get_loss`` and ``draw_loss_noise``. Its random numbers come in as
:class:`TrainNoise`, so one step can be checked against the JAX package's
given the same noise.

With ``grad_accum`` K > 1 (trainer.py:194-225) the batch is padded with
fully masked graphs to a multiple of K and split into K microbatches on
its leading axis; each has its own noise (drawn one microbatch after
another, as JAX's ``split(key, K)`` gives one key to each); the float32
gradients are summed, divided by K, and the loss terms averaged.

On the data axis (``mesh`` with data W > 1, one process per rank, see
parallel/mesh.py) the batch given to every rank is the global one: each
rank pads it to a multiple of W x K, keeps its rows of each microbatch
(microbatch i is rows [i B/K, (i+1) B/K), JAX's PartitionSpec(None,
DATA_AXIS)) and slices its rows of the noise, which every rank draws for
the whole padded batch from the same generator. The masked means' counts
are summed over the ranks before the forward pass (one all-reduce), so
each rank's loss is its share of the global batch's; one all-reduce of a
flat buffer sums the gradients and the loss terms. Adam and the EMA then
run identically on every rank. With ``fsdp`` the params, adam moments and
EMA are held sharded at rest (parallel/mesh.py fsdp_placement: one slice
of each leaf per rank, or the whole leaf); a step gathers the params once,
reduce-scatters the gradients, takes the norm from all-reduced sums of
squares and updates the shards. A step at world W computes the world-1
step on the padded batch up to the order of its sums.

On a (data, pipe) or (data, expert) mesh (trainer.py:124-154) the batch is
split over data alone: the ranks of one data coordinate see the same rows
and the same noise, and the counts are summed over the data group. With
``pipe`` MolDiff's denoiser runs as a GPipe pipeline (parallel/pipeline.py;
``pp``: the model has a ``pipeline_cfg``, so the bond predictor trains with
the pipe ranks as replicas, as in JAX) and the stacked block leaves are
held split over the stages (``pipe_param_sharding``); with ``expert`` the
MoE expert banks are held split over the expert ranks
(``ep_param_sharding``), and the MoE layers read the mesh (models/moe.py
MoEComm). MoE on a data axis above 1 computes JAX's global capacity,
positions and load-balance loss in the same way. Every rank of one data
coordinate then holds the whole gradient of the replicated leaves (the
embedders', on the pipe, on stage 0 alone) and of its own shards, and the
loss of its rows: the replicated leaves' gradients and the loss terms are
taken from axis coordinate 0 (zero elsewhere) and summed over the world,
the shards' over the data group, so each is counted once. The norm for
clipping sums the shards' squares over the axis group. Params, adam
moments and EMA are held in these placements at rest.

On a mesh with a graph axis ((data, graph), or (data, graph, model):
trainer.py:102-124, :158-176) the model gets the mesh's pair sharding and
runs JAX's plain route with its pair tensors split by receiver over graph
(models/denoiser.py); the batch is split over data alone. With a model
axis above 1 (``tp``) the params, adam moments and EMA are held in
``tp_param_sharding``'s placements (the MLPs' hidden widths split over
model; the model's split MLPs are marked, models/nn.py ShardedMLP) and the
MLPs run as Megatron's pair. The model's own collectives leave every
parameter's gradient whole on every graph and model rank (each split leaf's
for its shard), so the gradients are summed over data alone, as on the
other axes; the clip norm counts each split leaf's squares over the model
group and each replicated leaf once, as JAX's ``optax.global_norm`` of the
whole leaves. FSDP is exclusive with model, as in JAX, and allowed beside
graph and beside a pipe axis that runs no pipeline (the bond predictor's,
whose pipe ranks are replicas): its shards then live on every graph or
pipe rank of their data coordinate, and its collectives run over the data
group, so no gradient is summed over the axis beside it. Under ``moe`` the
expert banks run on the replicated nodes, their MLPs split over model like
the others (models/denoiser.py).

Checkpoints keep the JAX package's pickle layout (trainer.py:372-395):
``config``, float32 numpy ``params`` and ``ema_params``, ``step``,
``scheduler`` (its state_dict), ``key`` None and ``opt_state`` None, so
``moldiff_tpu.train.trainer.load_checkpoint`` and ``Trainer.load_checkpoint``
read them as they read a distribution checkpoint (a fresh optimizer). The
port's own optimizer state goes under ``extra["optimizer"]`` as numpy
arrays, and the port resumes from it.
"""
from __future__ import annotations

import glob
import os
import pickle
import shutil
import time
from typing import Any, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import pad_batch_to_multiple
from ..data.loader import BATCH_KEYS
from ..models.moe import MoEComm
from ..models.nn import mark_tp, unmark_tp
from ..parallel import collectives, pipeline
from ..parallel.mesh import (DATA_AXIS, EXPERT_AXIS, Mesh, all_gather_axis, all_reduce_sum,
                             broadcast_leaves, ep_enabled, ep_param_sharding, flatten,
                             fsdp_placement, graph_enabled, pair_sharding, pipe_enabled,
                             rank_rows, replicated, tp_enabled, tp_param_sharding, unflatten)
from ..utils.checkpoint import load_checkpoint_numpy, params_to_torch
from . import checkpoint_sharded
from .optim import (OptState, Optimizer, get_lr, get_scheduler, global_norm, set_lr,
                    tree_leaves, tree_map, tree_unflatten)

class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int
    ema_params: Any = None


class TrainNoise(NamedTuple):
    """The random numbers of one train or eval step (of one microbatch)."""
    jitter: Optional[torch.Tensor]   # [B, N, 3] standard normal (pos_noise_std > 0)
    loss: Any                        # the model's: LossNoise or BondLossNoise


def batch_to_device(batch: dict, device: "str | torch.device") -> dict:
    """A loader batch (numpy) -> tensors on ``device``, class indices long."""
    out = {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in BATCH_KEYS}
    out["node_type"] = out["node_type"].long()
    out["halfedge_type"] = out["halfedge_type"].long()
    return out


def _to_numpy(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().cpu().numpy().astype(np.float32), tree)


def _copy(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().clone(), tree)


def _rows(noise: Any, rows: slice) -> Any:
    """``rows`` of every tensor of a (nested) noise tuple; None stays None."""
    if isinstance(noise, tuple):
        return type(noise)(*(_rows(x, rows) for x in noise))
    return None if noise is None else noise[rows]


def _moe_static(model) -> Optional[dict]:
    """The model's static config when its denoiser or encoder is MoE."""
    static = getattr(model, "denoiser_static", None) or getattr(model, "encoder_static", {})
    return static if static.get("moe") else None


class Trainer:
    """Owns the optimizer and scheduler; ``model`` exposes
    ``init_params(generator)``, ``draw_loss_noise(b, n, generator)``,
    ``loss_counts(node_type, halfedge_type, node_mask)`` and
    ``get_loss(params, node_type, pos, halfedge_type, node_mask, noise,
    counts)`` (MolDiff and BondPredictor do). ``mesh``: this process's
    rank of the mesh (parallel/mesh.py), ``fsdp`` the data axis's
    sharding."""

    def __init__(self, model, train_config: dict, mesh: Optional[Mesh] = None,
                 fsdp: bool = False):
        self.model = model
        self.config = train_config
        # the mesh: None without ranks to split over and no process group (a
        # mesh of one rank inside a process group runs the mesh path, its
        # collectives over the one rank); fsdp only when the data axis has
        # ranks to shard over, as in JAX (trainer.py:132-143)
        active = mesh is not None and (mesh.world_size > 1 or dist.is_initialized())
        self.mesh = mesh if active else None
        self.world = self.mesh.world_size if self.mesh is not None else 1
        self.n_data = self.mesh.data if self.mesh is not None else 1
        self.fsdp = bool(fsdp) and self.n_data > 1
        # the pipe axis runs MolDiff's denoiser as a pipeline (trainer.py:124-131)
        self.pp = pipe_enabled(self.mesh) and hasattr(model, "pipeline_cfg")
        if self.pp:
            model.pipeline_cfg = (self.mesh, train_config.get("num_microbatches"))
        # the graph and model axes: JAX's plain route, the pair tensors split
        # by receiver (trainer.py:102-108); tensor parallelism over model
        self.graph = graph_enabled(mesh)
        self.tp = tp_enabled(self.mesh)
        if self.graph and hasattr(model, "pair_sharding"):
            model.pair_sharding = pair_sharding(self.mesh if active else mesh)
        if self.fsdp and (self.tp or self.pp):
            raise ValueError(
                "fsdp is exclusive with the 'model'/'pipe' axes: both shard "
                "the same param leaves with conflicting layouts")
        self.ep = ep_enabled(self.mesh)
        if self.ep and self.fsdp:
            raise ValueError(
                "fsdp is exclusive with the 'expert' axis: conflicting "
                "layouts on expert leaves")
        if self.mesh is not None and self.mesh.axis_size > 1:
            self.mesh.group(DATA_AXIS)   # every rank makes the groups here, in one order
        static = _moe_static(model)
        if static is not None and self.mesh is not None and (self.n_data > 1 or self.ep):
            # the expert banks read the mesh (models/moe.py)
            m = self.mesh
            static["moe"] = dict(static["moe"], comm=MoEComm(
                m.data, m.data_rank, m.group(DATA_AXIS), m.expert, m.coord(EXPERT_AXIS),
                m.group(EXPERT_AXIS) if self.ep else None))
        # one Placement per param leaf: the data axis's under FSDP, the pipe,
        # expert or model axis's on those meshes (and, under tp, their tree)
        self.places: Optional[list] = None
        self.place_tree: Any = None
        self.pipe_stats: dict = {}           # the pipeline's transfers, last step
        self.comm_s = 0.0                    # seconds in collectives, last step
        self.model_comm: dict = {}           # the model's own (graph, model axes), last step
        self.grad_accum = int(train_config.get("grad_accum", 1) or 1)
        opt_cfg = dict(train_config["optimizer"])
        opt_cfg.setdefault("max_grad_norm", train_config.get("max_grad_norm", 0.0))
        self.optimizer = Optimizer(opt_cfg)
        self.scheduler = get_scheduler(train_config["scheduler"], base_lr=float(opt_cfg["lr"]))
        self.pos_noise_std = float(train_config.get("pos_noise_std", 0.0))
        self.ema_decay = float(train_config.get("ema_decay", 0.0) or 0.0)

    # -- steps -----------------------------------------------------------------

    def _draw(self, b: int, n: int, generator: torch.Generator) -> TrainNoise:
        jitter = None
        if self.pos_noise_std > 0:
            jitter = torch.randn((b, n, 3), generator=generator, device=self.model.device)
        return TrainNoise(jitter, self.model.draw_loss_noise(b, n, generator))

    def _padded(self, b: int) -> int:
        """The global batch padded to a multiple of data x grad_accum
        (trainer.py:284-293)."""
        mult = self.n_data * self.grad_accum
        return -(-b // mult) * mult

    def draw_noise(self, batch: dict, generator: torch.Generator) -> TrainNoise:
        """Fresh noise for :meth:`eval_step` on ``batch``, padded to a
        multiple of data x ``grad_accum``: one TrainNoise for the whole
        (global) batch."""
        b, n = batch["node_type"].shape
        return self._draw(self._padded(b), n, generator)

    def draw_step_noise(self, batch: dict, generator: torch.Generator) -> List[TrainNoise]:
        """Fresh noise for :meth:`train_step` on ``batch``: one TrainNoise
        per microbatch of the (global) batch padded to a multiple of data x
        ``grad_accum``, drawn one microbatch after another."""
        b, n = batch["node_type"].shape
        k = self.grad_accum
        return [self._draw(self._padded(b) // k, n, generator) for _ in range(k)]

    def loss_fn(self, params, batch: dict, noise: TrainNoise, counts: Optional[dict] = None):
        """(loss, dict of loss terms) with the position jitter applied
        (trainer.py:55-76); ``counts``: the masked means' global counts."""
        pos = batch["pos"]
        if self.pos_noise_std > 0:
            pos = pos + self.pos_noise_std * noise.jitter
        kw = {} if counts is None else {"counts": counts}
        return self.model.get_loss(params, batch["node_type"], pos, batch["halfedge_type"],
                                   batch["node_mask"], noise.loss, **kw)

    def _grads(self, params, batch: dict, noise: TrainNoise, counts: Optional[dict] = None):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = self.loss_fn(tree_unflatten(params, leaves), batch, noise, counts)
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in aux.items()}

    # -- the mesh ---------------------------------------------------------------

    def _collective(self, fn, *args, **kwargs):
        """Run one collective, its seconds (after the work queued before
        it) added to ``comm_s``."""
        sync = self.mesh.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.mesh.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize(self.mesh.device)
        self.comm_s += time.perf_counter() - t0
        return out

    def _local(self, batch: dict, noise: List[TrainNoise]) -> list:
        """This rank's (microbatch, noise) pairs of the global batch (its
        data coordinate's rows), and each microbatch's counts summed over
        the data group (one all-reduce)."""
        k = len(noise)
        batch = pad_batch_to_multiple(batch, self.n_data * k)
        m = batch["node_type"].shape[0] // k
        rows = rank_rows(m, self.mesh)
        micros = [({key: v[i * m:(i + 1) * m][rows] for key, v in batch.items()},
                   _rows(noise[i], rows)) for i in range(k)]
        counts = [self.model.loss_counts(mb["node_type"], mb["halfedge_type"], mb["node_mask"])
                  for mb, _ in micros]
        flat = self._collective(all_reduce_sum, [v for c in counts for v in c.values()],
                                group=self.mesh.group(DATA_AXIS))
        it = iter(flat)
        return [(mb, nz, {name: next(it) for name in c}) for (mb, nz), c in zip(micros, counts)]

    def _sharded(self) -> List[int]:
        return [j for j, p in enumerate(self.places or []) if p.dim is not None]

    def gather(self, tree: Any) -> Any:
        """The whole leaves of a tree of shards (params, moments or EMA), by
        one all-gather of the sharded leaves over their axis; replicated
        leaves are kept. Without shards the tree itself."""
        if not self._sharded() or tree is None:
            return tree
        return unmark_tp(tree_unflatten(tree, all_gather_axis(
            self.mesh, self.places, tree_leaves(tree), run=self._collective)))

    def shard(self, tree: Any) -> Any:
        """This rank's shards of a tree of whole leaves (its split MLPs
        marked under tp)."""
        if self.places is None or tree is None:
            return tree
        out = tree_unflatten(tree, [p.take(x, self.mesh.coord(p.axis))
                                    for p, x in zip(self.places, tree_leaves(tree))])
        return mark_tp(out, self.place_tree) if self.tp else out

    def _once(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """``values`` (replicated over the axis beside data) summed over the
        world with each data coordinate's counted once: from axis
        coordinate 0."""
        if self.mesh.axis_size > 1 and self.mesh.axis_rank != 0:
            values = [torch.zeros_like(v) for v in values]
        return self._collective(all_reduce_sum, values)

    def _reduce(self, grads: List[torch.Tensor], aux: dict) -> tuple:
        """(gradients summed over the ranks: this rank's shards under FSDP,
        the global norm before clipping, the summed loss terms)."""
        names, grads = list(aux), list(grads)
        if not self.fsdp and not self._sharded():
            out = self._once(grads + [aux[k] for k in names])
            grads = out[:len(grads)]
            return grads, global_norm(grads), dict(zip(names, out[len(grads):]))
        if not self.fsdp:
            # the pipe, expert or model shards: summed over the data group;
            # their squares over their axis's group for the norm
            sh = self._sharded()
            rep = [j for j in range(len(grads)) if j not in set(sh)]
            out = self._once([grads[j] for j in rep] + [aux[k] for k in names])
            mine = [grads[j] for j in sh]
            if self.n_data > 1:
                mine = self._collective(all_reduce_sum, mine, group=self.mesh.group(DATA_AXIS))
            local = list(grads)
            for j, g in zip(rep + sh, out[:len(rep)] + mine):
                local[j] = g
            sq = global_norm(mine).square().reshape(1)
            self._collective(dist.all_reduce, sq,
                             group=self.mesh.group(self.places[sh[0]].axis))
            norm = torch.sqrt(sq[0] + global_norm(out[:len(rep)]).square())
            return local, norm, dict(zip(names, out[len(rep):]))
        # FSDP: the shards reduce-scattered over the data group (the ranks of
        # the graph axis beside it hold copies), the rest all-reduced there
        idx = set(self._sharded())
        rep = [j for j in range(len(grads)) if j not in idx]
        sh = sorted(idx)
        group = self.mesh.group(DATA_AXIS)
        inputs = [flatten([self.places[j].take(grads[j], r) for j in sh])
                  for r in range(self.n_data)]
        mine = torch.empty_like(inputs[0])
        self._collective(dist.reduce_scatter, mine, inputs, group=group)
        out = self._collective(all_reduce_sum, [grads[j] for j in rep] + [aux[k] for k in names],
                               group=group)
        local = list(grads)
        shapes = [torch.empty(self.places[j].shard_shape, device="meta") for j in sh]
        for j, g in zip(sh, unflatten(mine, shapes)):
            local[j] = g
        for j, g in zip(rep, out[:len(rep)]):
            local[j] = g
        sq = torch.sum(mine * mine).reshape(1)
        self._collective(dist.all_reduce, sq, group=group)
        rep_sq = sum((torch.sum(g * g) for g in out[:len(rep)]), torch.zeros((), device=sq.device))
        norm = torch.sqrt(sq[0] + rep_sq)
        return local, norm, dict(zip(names, out[len(rep):]))

    def _with_ema(self, state: "TrainState", new_params, opt_state) -> "TrainState":
        ema = state.ema_params
        if self.ema_decay > 0:
            d = self.ema_decay
            ema = tree_unflatten(ema, torch._foreach_add(
                torch._foreach_mul(tree_leaves(ema), d),
                torch._foreach_mul(tree_leaves(new_params), 1.0 - d)))
        return TrainState(new_params, opt_state, state.step + 1, ema)

    def gradient(self, state: TrainState, batch: dict,
                 noise: Union[TrainNoise, Sequence[TrainNoise]]) -> tuple:
        """(gradient leaves, their global norm, the loss terms) of one step
        on ``batch`` (the global batch on every rank): with grad_accum K the
        mean of the microbatches' gradients and terms; on the data axis
        summed over the ranks, this rank's shards of it under FSDP.
        ``noise`` holds one TrainNoise per microbatch
        (:meth:`draw_step_noise`); with grad_accum 1 it may be the one
        TrainNoise itself."""
        k = self.grad_accum
        noise = [noise] if isinstance(noise, TrainNoise) else list(noise)
        assert len(noise) == k, (len(noise), k)
        if self.mesh is not None:
            self.comm_s = 0.0
            pipeline.reset_stats()
            collectives.reset_stats()
            params = self.gather(state.params) if self.fsdp else state.params
            micros = self._local(batch, noise)
        elif k == 1:
            params, micros = state.params, [(batch, noise[0], None)]
        else:
            params = state.params
            batch = pad_batch_to_multiple(batch, k)
            m = batch["node_type"].shape[0] // k
            micros = [({key: v[i * m:(i + 1) * m] for key, v in batch.items()}, nz, None)
                      for i, nz in enumerate(noise)]
        grads, auxs = None, []
        for mb, nz, counts in micros:
            g, a = self._grads(params, mb, nz, counts)
            grads = g if grads is None else torch._foreach_add(grads, g)
            auxs.append(a)
        if k > 1:
            grads = torch._foreach_div(grads, float(k))
            aux = {key: torch.stack([a[key] for a in auxs]).mean() for key in auxs[0]}
        else:
            aux = auxs[0]
        if self.mesh is not None:
            out = self._reduce(grads, aux)
            self.pipe_stats = dict(pipeline.stats) if self.pp else {}
            self.model_comm = dict(collectives.stats)
            return out
        return grads, global_norm(grads), aux

    def train_step(self, state: TrainState, batch: dict,
                   noise: Union[TrainNoise, Sequence[TrainNoise]]):
        """One optimizer step -> (new state, aux); aux holds the loss terms
        and ``grad_norm``, the global norm before clipping (trainer.py:229).
        ``noise`` as :meth:`gradient` takes it."""
        grads, norm, aux = self.gradient(state, batch, noise)
        aux["grad_norm"] = norm
        new_params, opt_state = self.optimizer.update(
            tree_unflatten(state.params, grads), state.opt_state, state.params,
            g_norm=norm if self.mesh is not None else None)
        return self._with_ema(state, new_params, opt_state), aux

    @torch.no_grad()
    def eval_step(self, params, batch: dict, noise: TrainNoise) -> dict:
        """The loss terms on the whole (global) batch, padded to a multiple
        of data x grad_accum as the JAX step pads it; on the data axis each
        rank computes its rows' share and the shares are summed, so every
        rank returns the global terms (``params``: this rank's shards under
        FSDP)."""
        if self.mesh is None:
            return self.loss_fn(params, pad_batch_to_multiple(batch, self.grad_accum), noise)[1]
        mb, nz, counts = self._local(batch, [noise])[0]
        aux = self.loss_fn(self.gather(params) if self.fsdp else params, mb, nz, counts)[1]
        return dict(zip(aux, self._once(list(aux.values()))))

    def scheduler_step(self, state: TrainState, val_metric: float) -> TrainState:
        """The host-side learning-rate update between steps."""
        set_lr(state.opt_state, self.scheduler.step(val_metric, get_lr(state.opt_state)))
        return state

    # -- state and checkpoints -------------------------------------------------

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Fresh params from ``generator``, a fresh optimizer, EMA a copy of
        the params (trainer.py:274-282)."""
        return self.init_from_params(self.model.init_params(generator))

    def init_from_params(self, params: Any, step: int = 0, ema_params: Any = None) -> TrainState:
        """A state with a fresh optimizer; EMA seeded from a copy of the
        params unless given (trainer.py:327-333). On the data axis every
        rank takes rank 0's params and EMA (one broadcast; a rank whose own
        differed raises on every rank), then keeps its shards of them: FSDP's,
        the pipe's or the expert axis's placements."""
        ema = None
        if self.ema_decay > 0:
            ema = _copy(params) if ema_params is None else ema_params
        if self.mesh is not None:
            if ema is None:
                (params,), equal = broadcast_leaves((params,))
            else:
                (params, ema), equal = broadcast_leaves((params, ema))
            differ = torch.tensor([0.0 if equal else 1.0], device=self.mesh.comm_device())
            dist.all_reduce(differ)
            if float(differ[0]):
                raise RuntimeError(f"the params differed on {int(differ[0])} rank(s) before "
                                   "the broadcast from rank 0")
            if self.fsdp:
                self.places = [fsdp_placement(tuple(x.shape), self.n_data)
                               for x in tree_leaves(params)]
            elif self.pp:
                self.places = tree_leaves(pipeline.pipe_param_sharding(self.mesh, params))
            elif self.ep:
                self.places = tree_leaves(ep_param_sharding(self.mesh, params))
            elif self.tp:
                self.place_tree = tp_param_sharding(self.mesh, params)
                self.places = tree_leaves(self.place_tree)
            params, ema = self.shard(params), self.shard(ema)
        return TrainState(params, self.optimizer.init(params), int(step), ema)

    def gathered(self, state: TrainState) -> TrainState:
        """The state with whole leaves (a collective where leaves are
        sharded: every rank calls it); the state itself otherwise."""
        if not self._sharded():
            return state
        opt = state.opt_state
        return TrainState(self.gather(state.params),
                          OptState(opt.count, self.gather(opt.mu), self.gather(opt.nu), opt.lr),
                          state.step, self.gather(state.ema_params))

    def load_checkpoint(self, path: str, device: "str | torch.device") -> TrainState:
        """Trainer.load_checkpoint (trainer.py:318-350): a distribution
        checkpoint (``opt_state`` None, no port optimizer under ``extra``)
        starts a fresh optimizer; a checkpoint the port wrote resumes its
        moments and learning rate."""
        if checkpoint_sharded.is_sharded_checkpoint(path):
            blob = checkpoint_sharded.load_checkpoint_sharded(path)
            state, saved = blob["state"], None
            if state.get("opt_state") is not None:
                saved = {k: state["opt_state"][k] for k in ("count", "mu", "nu", "lr")}
            blob = dict(blob, params=state["params"], ema_params=state.get("ema_params"),
                        step=int(state["step"]))
        else:
            blob = load_checkpoint_numpy(path)
            saved = (blob.get("extra") or {}).get("optimizer")
        params = params_to_torch(blob["params"], device)
        ema = blob.get("ema_params")
        ema = params_to_torch(ema, device) if ema is not None else None
        state = self.init_from_params(params, blob.get("step", 0) or 0, ema)
        if saved is not None:
            state.opt_state.count = int(saved["count"])
            state.opt_state.mu = self.shard(params_to_torch(saved["mu"], device))
            state.opt_state.nu = self.shard(params_to_torch(saved["nu"], device))
            state.opt_state.lr = float(saved["lr"])
        if blob.get("scheduler") is not None:
            self.scheduler.load_state_dict(blob["scheduler"])
        return state

    def save_checkpoint(self, path: str, state: TrainState, config: Any,
                        extra: Optional[dict] = None) -> None:
        """The pickle checkpoint, written by rank 0 from the whole state
        (every rank calls it: under FSDP the leaves are gathered)."""
        state = self.gathered(state)
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(path, state, config, scheduler=self.scheduler, extra=extra)

    def save_checkpoint_sharded(self, path: str, state: TrainState, config: Any,
                                extra: Optional[dict] = None) -> None:
        """A sharded checkpoint directory (checkpoint_sharded.py): each
        shard is written by the rank that holds it at data coordinate 0,
        the replicated leaves and meta.pkl by rank 0 (every rank calls
        it)."""
        mesh = self.mesh
        rank = mesh.rank if mesh is not None else 0
        coords = {a: mesh.coord(a) for a in mesh.axes} if mesh is not None else None
        checkpoint_sharded.save_checkpoint_sharded(
            path, self.state_entries(state), rank=rank, world=self.world,
            config=config, scheduler=self.scheduler, extra=extra, coords=coords)

    def state_entries(self, state: TrainState) -> list:
        """(key path, this rank's array, Placement) per leaf of ``state``,
        in the order of JAX's TrainState (params, opt_state, step, EMA;
        dict keys sorted), so that params leaf i is JAX's leaf i."""
        places = self.places or [replicated(x.shape) for x in tree_leaves(state.params)]
        rep = replicated(())
        opt = state.opt_state

        def entries(prefix: tuple, tree: Any) -> list:
            return [(prefix + path, x, p) for (path, x), p in
                    zip(checkpoint_sharded.key_paths(tree), places)]

        out = entries(("params",), state.params)
        out.append((("opt_state", "count"), np.asarray(opt.count, np.int64), rep))
        out += entries(("opt_state", "mu"), opt.mu) + entries(("opt_state", "nu"), opt.nu)
        out.append((("opt_state", "lr"), np.asarray(opt.lr, np.float64), rep))
        out.append((("step",), np.asarray(state.step, np.int32), rep))
        if state.ema_params is not None:
            out += entries(("ema_params",), state.ema_params)
        return out

def checkpoint_blob(state: TrainState, config: Any, scheduler=None,
                    extra: Optional[dict] = None) -> dict:
    """A host copy of ``state`` in the JAX package's pickle layout
    (trainer.py:372-395), the port's optimizer state under
    ``extra["optimizer"]``: later updates of the state leave it as it is."""
    opt = state.opt_state
    extra = dict(extra or {})
    extra["optimizer"] = {"count": int(opt.count), "mu": _to_numpy(opt.mu),
                          "nu": _to_numpy(opt.nu), "lr": float(opt.lr)}
    return {
        "config": config.to_dict() if hasattr(config, "to_dict") else config,
        "params": _to_numpy(state.params),
        "opt_state": None,
        "step": int(state.step),
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        "key": None,
        "extra": extra,
        "ema_params": _to_numpy(state.ema_params) if state.ema_params is not None else None,
    }


def write_checkpoint(path: str, blob: dict) -> None:
    """Pickle ``blob`` to ``path`` through a temporary file and an atomic
    rename: ``path`` is never a partial file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, config: Any, scheduler=None,
                    extra: Optional[dict] = None) -> None:
    write_checkpoint(path, checkpoint_blob(state, config, scheduler, extra))


def prune_checkpoints(ckpt_dir: str, keep: int) -> List[str]:
    """Keep only the ``keep`` newest numeric checkpoints (``<it>.ckpt``)
    under ``ckpt_dir``; other names (best.ckpt) are never touched, and
    ``keep`` <= 0 keeps all (trainer.py:398-421). Returns the removed
    paths."""
    if keep <= 0:
        return []
    numeric = []
    for p in glob.glob(os.path.join(ckpt_dir, "*.ckpt")):
        stem = os.path.splitext(os.path.basename(p))[0]
        if stem.isdigit():
            numeric.append((int(stem), p))
    numeric.sort()
    removed = []
    for _, p in numeric[:-keep]:
        if os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.remove(p)
        removed.append(p)
    return removed
