"""The data axis: process groups, the mesh record and the placements of
data-parallel and fully sharded training (moldiff_tpu/parallel/mesh.py).

JAX runs one program over a device mesh and lets GSPMD place the
collectives. Here each rank is a process with one device, and the trainer
calls ``torch.distributed`` itself: the batch is split over the ``data``
axis, the gradients are all-reduced (or reduce-scattered under FSDP), and
the parameters are identical on every rank (or sharded, one slice each).

Only the data axis is ported. The ``graph``, ``model``, ``pipe`` and
``expert`` axes need collectives between the denoiser's kernels; a config
that asks for one of them raises NotImplementedError (ROADMAP.md lists
them as the next slice).

Backends: ``nccl`` for CUDA with one rank per card, ``gloo`` for the CPU
(and, asked for explicitly, for several ranks that share one card: NCCL
refuses two ranks on one device).
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass, replace
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..data.batching import pad_batch_to_multiple  # noqa: F401  (mesh.py:337-348)
from ..utils.tree import tree_leaves, tree_map, tree_unflatten

DATA_AXIS = "data"
GRAPH_AXIS = "graph"    # shards the pair tensors' receiver axis (not ported)
MODEL_AXIS = "model"    # tensor parallelism over MLP hidden dims (not ported)
EXPERT_AXIS = "expert"  # expert parallelism over MoE banks (not ported)

# a dead rank fails the run after this long instead of hanging it
DEFAULT_TIMEOUT_S = 600.0

NOT_PORTED = ("the {axis} axis is not ported yet: the port runs the data axis only "
              "(ROADMAP.md, the next slice: graph, model, pipe, expert)")


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
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device: "str | torch.device", rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:<rank mod visible cards>`` (one rank
    per card when there are as many cards as ranks), else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


@dataclass(frozen=True)
class Mesh:
    """The data axis of a run: its size, the process group's backend, and
    this process's rank and device. Built in the parent by
    :func:`make_mesh_from_config` (rank 0), then placed on each worker's
    rank with :meth:`at`."""
    data: int = 1
    backend: str = "gloo"
    rank: int = 0
    device: torch.device = torch.device("cpu")

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data}

    @property
    def world_size(self) -> int:
        return self.data

    def at(self, rank: int, device: "str | torch.device") -> "Mesh":
        return replace(self, rank=int(rank), device=torch.device(device))

    def comm_device(self) -> torch.device:
        """Where host integers go for a collective: NCCL takes CUDA
        tensors only, gloo takes host tensors."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_mesh_from_config(parallel_cfg: Optional[dict], device: "str | torch.device" = "cuda",
                          backend: Optional[str] = None) -> Mesh:
    """The mesh of a config's ``parallel:`` section, by the JAX rules
    (mesh.py:147-189): ``num_devices`` null means every visible card (one
    on the CPU); ``pipe`` is exclusive with graph / model and ``expert``
    with every other axis; num_devices must divide by their product; the
    data axis takes the rest. Any axis but data above 1 raises
    NotImplementedError. ``fsdp`` does not change the mesh (the trainer
    reads it). ``backend`` defaults to NCCL on CUDA (one rank per card:
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
    for axis, size in ((EXPERT_AXIS, n_expert), ("pipe", n_pipe), (MODEL_AXIS, n_model),
                       (GRAPH_AXIS, n_graph)):
        if size > 1:
            raise NotImplementedError(NOT_PORTED.format(axis=axis))
    backend = backend or default_backend(device)
    if backend == "nccl" and total > visible:
        raise ValueError(f"num_devices={total} but {visible} card(s) visible: NCCL takes one "
                         "rank per card (backend='gloo' may share a card)")
    return Mesh(data=total, backend=backend, rank=0, device=rank_device(device, 0))


# -- FSDP placement -------------------------------------------------------------

@dataclass(frozen=True)
class Placement:
    """A leaf's place on the data axis: ``dim`` None is replicated; else
    rank r holds ``[r * size, (r + 1) * size)`` of dimension ``dim``
    (JAX's NamedSharding with the data axis on ``dim``)."""
    shape: tuple
    dim: Optional[int]
    parts: int

    @property
    def shard_shape(self) -> tuple:
        if self.dim is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.parts
        return tuple(s)

    def index(self, rank: int) -> tuple:
        """Rank ``rank``'s slices of the whole leaf."""
        if self.dim is None:
            return tuple(slice(0, n) for n in self.shape)
        size = self.shape[self.dim] // self.parts
        return tuple(slice(rank * size, (rank + 1) * size) if d == self.dim else slice(0, n)
                     for d, n in enumerate(self.shape))

    def take(self, full: torch.Tensor, rank: int) -> torch.Tensor:
        if self.dim is None:
            return full
        size = self.shape[self.dim] // self.parts
        return full.narrow(self.dim, rank * size, size).contiguous()


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


# -- the batch ------------------------------------------------------------------

def rank_rows(b: int, mesh: Mesh) -> slice:
    """This rank's rows of a leading axis of ``b`` (a multiple of the data
    axis): JAX's PartitionSpec(DATA_AXIS)."""
    per = b // mesh.data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


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


def all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over ranks of ``tensors``, by one all-reduce of one flat
    float32 buffer."""
    flat = flatten(tensors)
    dist.all_reduce(flat)
    return unflatten(flat, tensors)


def broadcast_leaves(tree: Any, src: int = 0) -> tuple:
    """(rank ``src``'s leaves of ``tree`` in its structure, whether this
    rank's were bit-equal to them), by one broadcast of a flat buffer."""
    leaves = tree_leaves(tree)
    flat = flatten(leaves)
    mine = flat.clone()
    dist.broadcast(flat, src)
    return tree_unflatten(tree, unflatten(flat, leaves)), bool(torch.equal(flat, mine))
