"""Process groups, the mesh record and the placements of data-parallel,
fully sharded, graph-parallel, tensor-parallel, pipeline-parallel and
expert-parallel training (moldiff_tpu/parallel/mesh.py).

JAX runs one program over a device mesh and lets GSPMD place the
collectives. Here each rank is a process with one device, and the trainer
and the model call ``torch.distributed`` themselves: the batch is split
over the ``data`` axis, the gradients are all-reduced (or reduce-scattered
under FSDP), and the parameters are identical on every rank (or sharded,
one slice each).

A mesh has the data axis and at most one of: ``pipe`` (the denoiser's
stacked blocks split over stages, parallel/pipeline.py), ``expert`` (the
MoE expert banks split over ranks, models/moe.py), ``graph`` (the pair
tensors' receiver axis split over ranks, models/denoiser.py), or ``graph``
and ``model`` together (JAX's 3-D mesh: MLP hidden widths split over
``model``, models/nn.py; the graph axis may have size 1 there, as in
JAX). Ranks are laid out as JAX's ``devices.reshape(n_data, ...)``: rank
= d * A + a on a 2-D mesh, (d * G + g) * M + m on the 3-D one. Each axis
has its own process groups (:meth:`Mesh.group`): the group of a rank along
an axis is the ranks that differ from it on that axis alone (its data
group holds the same shards, its graph or model group sees the same rows
of the batch).

Backends: ``nccl`` for CUDA with one rank per card, ``gloo`` for the CPU
(and, asked for explicitly, for several ranks that share one card: NCCL
refuses two ranks on one device).
"""
from __future__ import annotations

import datetime
import itertools
import math
from dataclasses import dataclass, replace
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..data.batching import pad_batch_to_multiple  # noqa: F401  (mesh.py:337-348)
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .collectives import Axis, PairSharding

DATA_AXIS = "data"
GRAPH_AXIS = "graph"    # shards the pair tensors' receiver axis
MODEL_AXIS = "model"    # tensor parallelism over MLP hidden dims
PIPE_AXIS = "pipe"      # pipeline parallelism over the stacked blocks
EXPERT_AXIS = "expert"  # expert parallelism over MoE banks

# a dead rank fails the run after this long instead of hanging it
DEFAULT_TIMEOUT_S = 600.0

def default_backend(device: "str | torch.device") -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (mesh.py:25-37); a no-op for one process.

    ``coordinator_address``: ``host:port`` of process 0 (TCP rendezvous) or
    a ``file://`` path that every process can reach (a FileStore, which
    needs no port)."""
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None or coordinator_address is None:
        raise ValueError("a multi-process run needs process_id and coordinator_address")
    method = coordinator_address
    if "://" not in method:
        method = f"tcp://{method}"
    dist.init_process_group(backend, init_method=method, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_distributed() -> None:
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device: "str | torch.device", rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:<rank mod visible cards>`` (one rank
    per card when there are as many cards as ranks), else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


# (axes, sizes) -> {axis: {the other axes' coordinates: the line's group}},
# made once per process group
_GROUPS: dict = {}


@dataclass(frozen=True)
class Mesh:
    """A run's axes (``axes``: ``("data",)``, ``("data", A)`` with A one of
    pipe, expert and graph, or ``("data", "graph", "model")``) and their
    sizes, the process group's backend, and this process's rank and
    device. Built in the parent by :func:`make_mesh_from_config` (rank 0),
    then placed on each worker's rank with :meth:`at`."""
    data: int = 1
    backend: str = "gloo"
    rank: int = 0
    device: torch.device = torch.device("cpu")
    pipe: int = 1
    expert: int = 1
    axes: tuple = (DATA_AXIS,)
    graph: int = 1
    model: int = 1

    def size(self, axis: str) -> int:
        return {DATA_AXIS: self.data, PIPE_AXIS: self.pipe, EXPERT_AXIS: self.expert,
                GRAPH_AXIS: self.graph, MODEL_AXIS: self.model}[axis]

    @property
    def shape(self) -> dict:
        return {a: self.size(a) for a in self.axes}

    @property
    def world_size(self) -> int:
        return self.data * self.pipe * self.expert * self.graph * self.model

    @property
    def axis_size(self) -> int:
        """The ranks of one data coordinate (the product of the other axes)."""
        return self.world_size // self.data

    @property
    def data_rank(self) -> int:
        return self.rank // self.axis_size

    @property
    def axis_rank(self) -> int:
        """This rank's place among the ranks of its data coordinate."""
        return self.rank % self.axis_size

    def _stride(self, axis: str) -> int:
        i = self.axes.index(axis)
        return math.prod(self.size(a) for a in self.axes[i + 1:])

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.axes:
            return 0
        return (self.rank // self._stride(axis)) % self.size(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``: None (the
        whole world) where that line is the world. Every rank must make
        its first call at the same point: the groups are made then, all of
        them on every rank (every line of every axis), in one order."""
        if self.size(axis) == self.world_size:
            return None
        key = (self.axes, tuple(self.size(a) for a in self.axes))
        if key not in _GROUPS:
            lines = {}
            for a in self.axes:
                others = [b for b in self.axes if b != a]
                lines[a] = {}
                for rest in itertools.product(*(range(self.size(b)) for b in others)):
                    at = dict(zip(others, rest))
                    ranks = [sum(dict(at, **{a: c})[b] * self._stride(b) for b in self.axes)
                             for c in range(self.size(a))]
                    lines[a][rest] = dist.new_group(ranks)
            _GROUPS[key] = lines
        rest = tuple(self.coord(b) for b in self.axes if b != axis)
        return _GROUPS[key][axis][rest]

    def group_rank(self, axis: str, coord: int) -> int:
        """The global rank at ``coord`` on ``axis`` of this rank's line."""
        return self.rank + (coord - self.coord(axis)) * self._stride(axis)

    def at(self, rank: int, device: "str | torch.device") -> "Mesh":
        return replace(self, rank=int(rank), device=torch.device(device))

    def comm_device(self) -> torch.device:
        """Where host integers go for a collective: NCCL takes CUDA
        tensors only, gloo takes host tensors."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_mesh_pipe(n_data: int, n_pipe: int, device: "str | torch.device" = "cpu",
                   backend: Optional[str] = None) -> Mesh:
    """The (data, pipe) mesh (pipeline.py:38-46): batch over data, the
    denoiser's stacked blocks over pipe."""
    device = torch.device(device)
    return Mesh(data=int(n_data), pipe=int(n_pipe), axes=(DATA_AXIS, PIPE_AXIS),
                backend=backend or default_backend(device), device=rank_device(device, 0))


def make_mesh_expert(n_data: int, n_expert: int, device: "str | torch.device" = "cpu",
                     backend: Optional[str] = None) -> Mesh:
    """The (data, expert) mesh (mesh.py:76-85): batch over data, MoE
    expert banks over expert."""
    device = torch.device(device)
    return Mesh(data=int(n_data), expert=int(n_expert), axes=(DATA_AXIS, EXPERT_AXIS),
                backend=backend or default_backend(device), device=rank_device(device, 0))


def make_mesh_2d(n_data: int, n_graph: int, device: "str | torch.device" = "cpu",
                 backend: Optional[str] = None) -> Mesh:
    """The (data, graph) mesh (mesh.py:49-57): batch over data, the pair
    tensors' receiver axis over graph."""
    device = torch.device(device)
    return Mesh(data=int(n_data), graph=int(n_graph), axes=(DATA_AXIS, GRAPH_AXIS),
                backend=backend or default_backend(device), device=rank_device(device, 0))


def make_mesh_3d(n_data: int, n_graph: int, n_model: int, device: "str | torch.device" = "cpu",
                 backend: Optional[str] = None) -> Mesh:
    """The (data, graph, model) mesh (mesh.py:60-69): batch over data, the
    pair tensors' receiver axis over graph, MLP hidden widths over model
    (:func:`tp_param_sharding`)."""
    device = torch.device(device)
    return Mesh(data=int(n_data), graph=int(n_graph), model=int(n_model),
                axes=(DATA_AXIS, GRAPH_AXIS, MODEL_AXIS),
                backend=backend or default_backend(device), device=rank_device(device, 0))


def pipe_enabled(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and PIPE_AXIS in mesh.axes and mesh.pipe > 1


def ep_enabled(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and EXPERT_AXIS in mesh.axes and mesh.expert > 1


def tp_enabled(mesh: Optional[Mesh]) -> bool:
    """mesh.py:72-73: a model axis above 1."""
    return mesh is not None and MODEL_AXIS in mesh.axes and mesh.model > 1


def graph_enabled(mesh: Optional[Mesh]) -> bool:
    """Whether JAX sets ``pair_sharding`` on this mesh (mesh.py:312-319): it
    has a graph axis, of any size (a 3-D mesh always has one). The model
    then runs JAX's plain route, row-sharded (models/denoiser.py)."""
    return mesh is not None and GRAPH_AXIS in mesh.axes


def pair_sharding(mesh: Optional[Mesh]) -> Optional[PairSharding]:
    """mesh.py:312-319: where the mesh has a graph axis, the graph and
    model axes of this rank (both of size 1 at world 1 without a process
    group, as ``make_mesh_2d(1, 1)`` there); None otherwise."""
    if not graph_enabled(mesh):
        return None
    return PairSharding(Axis.of(mesh, GRAPH_AXIS), Axis.of(mesh, MODEL_AXIS))


def make_mesh_from_config(parallel_cfg: Optional[dict], device: "str | torch.device" = "cuda",
                          backend: Optional[str] = None) -> Mesh:
    """The mesh of a config's ``parallel:`` section, by the JAX rules
    (mesh.py:147-189): ``num_devices`` null means every visible card (one
    on the CPU); ``pipe`` is exclusive with graph / model and ``expert``
    with every other axis; num_devices must divide by their product; the
    data axis takes the rest: (data, expert) with expert above 1, else
    (data, pipe) with pipe above 1, else (data, graph, model) with model
    above 1 (graph may be 1 there), else (data, graph) with graph above 1,
    else data alone. ``fsdp`` does not change the mesh (the trainer reads
    it). ``backend`` defaults to NCCL on CUDA (one rank per card:
    num_devices above the visible cards raises) and gloo on the CPU; gloo,
    asked for, may put several ranks on one card."""
    cfg = dict(parallel_cfg or {})
    device = torch.device(device)
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    total = int(cfg.get("num_devices") or visible)
    if total < 1:
        raise RuntimeError(f"no {device.type} device visible for the mesh")
    n_graph = int(cfg.get("graph", 1) or 1)
    n_model = int(cfg.get("model", 1) or 1)
    n_pipe = int(cfg.get("pipe", 1) or 1)
    n_expert = int(cfg.get("expert", 1) or 1)
    if n_pipe > 1 and (n_graph > 1 or n_model > 1):
        raise ValueError("pipe is exclusive with graph/model axes")
    if n_expert > 1 and (n_graph > 1 or n_model > 1 or n_pipe > 1):
        raise ValueError("expert is exclusive with graph/model/pipe axes")
    if total % (n_graph * n_model * n_pipe * n_expert) != 0:
        raise ValueError(
            f"num_devices={total} not divisible by graph*model*pipe*expert="
            f"{n_graph * n_model * n_pipe * n_expert}")
    backend = backend or default_backend(device)
    if backend == "nccl" and total > visible:
        raise ValueError(f"num_devices={total} but {visible} card(s) visible: NCCL takes one "
                         "rank per card (backend='gloo' may share a card)")
    if n_expert > 1:
        return make_mesh_expert(total // n_expert, n_expert, device, backend)
    if n_pipe > 1:
        return make_mesh_pipe(total // n_pipe, n_pipe, device, backend)
    n_data = total // (n_graph * n_model)
    if n_model > 1:
        return make_mesh_3d(n_data, n_graph, n_model, device, backend)
    if n_graph > 1:
        return make_mesh_2d(n_data, n_graph, device, backend)
    return Mesh(data=total, backend=backend, rank=0, device=rank_device(device, 0))


# -- FSDP placement -------------------------------------------------------------

@dataclass(frozen=True)
class Placement:
    """A leaf's place on one mesh axis: ``dim`` None is replicated; else
    the rank at coordinate c of ``axis`` holds ``[c * size, (c + 1) *
    size)`` of dimension ``dim`` (JAX's NamedSharding with ``axis`` on
    ``dim``), and the ranks along the other axes hold copies of it."""
    shape: tuple
    dim: Optional[int]
    parts: int
    axis: str = DATA_AXIS

    @property
    def shard_shape(self) -> tuple:
        if self.dim is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.parts
        return tuple(s)

    def index(self, coord: int) -> tuple:
        """The slices of the whole leaf held at coordinate ``coord``."""
        if self.dim is None:
            return tuple(slice(0, n) for n in self.shape)
        size = self.shape[self.dim] // self.parts
        return tuple(slice(coord * size, (coord + 1) * size) if d == self.dim else slice(0, n)
                     for d, n in enumerate(self.shape))

    def take(self, full: torch.Tensor, coord: int) -> torch.Tensor:
        if self.dim is None:
            return full
        size = self.shape[self.dim] // self.parts
        return full.narrow(self.dim, coord * size, size).contiguous()


def replicated(shape: tuple) -> Placement:
    return Placement(tuple(int(s) for s in shape), None, 1)


def fsdp_placement(shape: tuple, n_data: int) -> Placement:
    """JAX's rule (mesh.py:279-309): the largest dimension that divides by
    the data axis and is at least its size (the first of equals), else
    replicated; scalars are replicated."""
    shape = tuple(int(s) for s in shape)
    if n_data <= 1 or len(shape) == 0:
        return Placement(shape, None, 1)
    divisible = [d for d in range(len(shape)) if shape[d] % n_data == 0 and shape[d] >= n_data]
    if not divisible:
        return Placement(shape, None, 1)
    return Placement(shape, max(divisible, key=lambda d: shape[d]), n_data)


def fsdp_param_sharding(mesh: "Mesh | int", tree: Any) -> Any:
    """A tree of :class:`Placement` of ``tree``'s structure (params, adam
    moments and EMA alike), one per leaf (anything with a ``shape``)."""
    n = mesh if isinstance(mesh, int) else mesh.data
    return tree_map(lambda x: fsdp_placement(tuple(x.shape), n), tree)


def _axis_size(mesh: "Mesh | int", axis: str) -> int:
    if isinstance(mesh, int):
        return mesh
    return mesh.size(axis) if axis in mesh.axes else 1


def ep_param_sharding(mesh: "Mesh | int", tree: Any) -> Any:
    """JAX's expert placement (mesh.py:92-144) as a tree of
    :class:`Placement`: in every dict holding ``router`` and ``experts``
    (an expert bank), each experts leaf is split over ``expert`` on the
    last of its first two dimensions equal to the router's fan-out E (dim
    1 of the stacked [num_blocks, E, ...] leaves) when E divides by the
    axis; routers and every other leaf are replicated."""
    n = _axis_size(mesh, EXPERT_AXIS)

    def expert_leaf(x, num_experts: int) -> Placement:
        shape = tuple(int(s) for s in x.shape)
        if n <= 1 or num_experts % n != 0 or len(shape) < 1:
            return replicated(shape)
        dims = [d for d in range(min(2, len(shape))) if shape[d] == num_experts]
        return Placement(shape, dims[-1], n, EXPERT_AXIS) if dims else replicated(shape)

    def walk(node):
        if isinstance(node, dict):
            if "router" in node and "experts" in node:
                e = int(node["router"]["w"].shape[-1])
                out = {k: walk(v) for k, v in node.items()}
                out["experts"] = tree_map(lambda x: expert_leaf(x, e), node["experts"])
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return replicated(node.shape)

    return walk(tree)


def pipe_placement(shape: tuple, n_pipe: int) -> Placement:
    """A leaf under a ``blocks`` key (pipeline.py:53-87): split on dim 0
    over ``pipe`` when it divides, else replicated."""
    shape = tuple(int(s) for s in shape)
    if n_pipe > 1 and len(shape) >= 1 and shape[0] % n_pipe == 0:
        return Placement(shape, 0, n_pipe, PIPE_AXIS)
    return replicated(shape)


def tp_param_sharding(mesh: "Mesh | int", tree: Any) -> Any:
    """JAX's Megatron placement (mesh.py:192-276) as a tree of
    :class:`Placement` on the ``model`` axis: in every MLP (a dict whose
    ``layers`` is a list of two or more dicts that each hold ``lin``)
    whose hidden width (layer 0's ``w``'s last dimension) divides by the
    axis, layer 0's ``lin`` leaves and ``ln`` leaves are split on their
    last dimension (column-parallel), the last layer's ``w`` on its
    second-to-last, contracting dimension (row-parallel; its bias
    replicated); middle layers, trailing LayerNorms, MLPs whose hidden
    width does not divide and every other leaf are replicated. Stacked
    block leaves ([num_blocks, ...]) split the same trailing dimensions.
    Params, adam moments and EMA alike; the experts of a MoE bank hold a
    ``layers`` list too, and are split the same way. ``mesh``: a Mesh or
    the model axis's size."""
    n = _axis_size(mesh, MODEL_AXIS)

    def place(x, dim: Optional[int]) -> Placement:
        shape = tuple(int(s) for s in x.shape)
        return Placement(shape, None if dim is None else len(shape) + dim, n, MODEL_AXIS)

    def walk_mlp(layers: list) -> list:
        hidden = int(layers[0]["lin"]["w"].shape[-1])
        if n <= 1 or hidden % n != 0:
            return tree_map(lambda x: replicated(x.shape), layers)
        last = len(layers) - 1
        out = []
        for i, layer in enumerate(layers):
            spec = {}
            for k, v in layer.items():
                if k in ("lin", "ln") and i == 0:
                    spec[k] = tree_map(lambda x: place(x, -1), v)
                elif k == "lin" and i == last:
                    spec[k] = {kk: place(vv, -2 if kk == "w" else None) for kk, vv in v.items()}
                else:
                    spec[k] = tree_map(lambda x: replicated(x.shape), v)
            out.append(spec)
        return out

    def walk(node):
        if isinstance(node, dict):
            layers = node.get("layers")
            if (isinstance(layers, (list, tuple)) and len(layers) >= 2
                    and all(isinstance(l, dict) and "lin" in l for l in layers)):
                out = {k: walk(v) for k, v in node.items() if k != "layers"}
                out["layers"] = type(layers)(walk_mlp(list(layers)))
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return replicated(node.shape)

    return walk(tree)


# -- collectives on one axis ----------------------------------------------------

def all_gather_axis(mesh: Mesh, places: List[Placement], leaves: List[torch.Tensor],
                    run=None) -> List[torch.Tensor]:
    """The whole leaves of ``leaves`` (this rank's shards in ``places``),
    by one all-gather per axis over that axis's group; replicated leaves
    are kept. ``run(fn, *args, **kw)`` calls each collective (to time it)."""
    run = run or (lambda fn, *a, **kw: fn(*a, **kw))
    out = list(leaves)
    for axis in sorted({p.axis for p in places if p.dim is not None}):
        idx = [j for j, p in enumerate(places) if p.dim is not None and p.axis == axis]
        mine = flatten([leaves[j] for j in idx])
        parts = [torch.empty_like(mine) for _ in range(mesh.size(axis))]
        run(dist.all_gather, parts, mine, group=mesh.group(axis))
        for j, *per in zip(idx, *(unflatten(p, [leaves[j] for j in idx]) for p in parts)):
            out[j] = torch.cat(per, dim=places[j].dim)
    return out


# -- the batch ------------------------------------------------------------------

def rank_rows(b: int, mesh: Mesh) -> slice:
    """This rank's rows of a leading axis of ``b`` (a multiple of the data
    axis): JAX's PartitionSpec(DATA_AXIS), the same rows on every rank of
    one data coordinate."""
    per = b // mesh.data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a batch whose leading axis divides by the data
    axis (mesh.py:331-335)."""
    b = next(iter(batch.values())).shape[0]
    if b % mesh.data:
        raise ValueError(f"batch of {b} does not divide over data={mesh.data}")
    rows = rank_rows(b, mesh)
    return {k: v[rows] for k, v in batch.items()}


# -- collectives ----------------------------------------------------------------

def flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def unflatten(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(t.dtype))
        at += n
    return out


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The sums over the ranks of ``group`` (None: all) of ``tensors``, by
    one all-reduce of one flat float32 buffer."""
    flat = flatten(tensors)
    dist.all_reduce(flat, group=group)
    return unflatten(flat, tensors)


def broadcast_leaves(tree: Any, src: int = 0, group=None) -> tuple:
    """(global rank ``src``'s leaves of ``tree`` in its structure, whether
    this rank's were bit-equal to them), by one broadcast of a flat buffer
    over ``group`` (None: all ranks)."""
    leaves = tree_leaves(tree)
    flat = flatten(leaves)
    mine = flat.clone()
    dist.broadcast(flat, src, group=group)
    return tree_unflatten(tree, unflatten(flat, leaves)), bool(torch.equal(flat, mine))
