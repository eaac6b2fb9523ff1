"""Differentiable collectives over one mesh axis, for the graph and model
axes (models/denoiser.py, models/nn.py).

JAX places these collectives itself (GSPMD, from ``pair_sharding`` and
``tp_param_sharding``); here they are written out, each an autograd
Function whose backward is the collective its forward needs, so that every
rank's autograd graph runs the same collectives in the same order (the
graphs are the same on every rank of an axis: the same ops on shards of
one shape).

The conjugate pairs, by what a tensor is on the axis's ranks:

- :func:`copy_to` -- a replicated tensor that enters work split over the
  axis: identity forward; backward all-reduces its gradient (each rank's
  work saw only its part of it);
- :func:`reduce_from` -- partial sums made replicated, then used as a
  replicated tensor (the gradient is whole on every rank): all-reduce
  forward, identity backward;
- :func:`all_reduce` -- partial sums made replicated and used again in
  split work: all-reduce forward and backward;
- :func:`gather` -- a split tensor made replicated (the gradient is whole
  on every rank): all-gather forward, the rank's slice backward;
- :func:`gather_shared` -- a split tensor gathered for split work: all-
  gather forward, reduce-scatter backward (:func:`gather` then
  :func:`copy_to`);
- :func:`scatter` -- a replicated tensor cut to the rank's slice for split
  work: slice forward, all-gather backward;
- :func:`reduce_scatter` -- partial sums of which each rank needs its
  slice: reduce-scatter forward, all-gather backward;
- :func:`once` -- a replicated value computed from tensors that passed
  :func:`copy_to`, whose gradient every rank holds whole: identity
  forward; backward the gradient on the axis's rank 0 and zero elsewhere,
  so that the all-reduces of :func:`copy_to` count it once.

Gathers and scatters split ``dim`` into ``size`` equal parts, rank r
holding part r. On an axis of one rank every function is the identity.
:data:`stats` counts each kind's seconds (a card is synchronised before
and after, so queued work is not counted) and bytes sent, since the last
:func:`reset_stats`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "reduce_scatter")
stats = {f"{k}_{q}": 0 for k in KINDS for q in ("s", "bytes", "calls")}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


@dataclass(frozen=True)
class Axis:
    """One mesh axis as a rank sees it: its size, this rank's coordinate
    and the process group of its line (None: the whole world)."""
    name: str
    size: int = 1
    rank: int = 0
    group: Any = None

    @classmethod
    def of(cls, mesh, axis: str) -> "Axis":
        """The Axis named ``axis`` of ``mesh`` (parallel/mesh.py Mesh): one
        of size 1 where the mesh lacks it or it has one rank."""
        if axis not in mesh.axes or mesh.size(axis) == 1:
            return cls(axis)
        return cls(axis, mesh.size(axis), mesh.coord(axis), mesh.group(axis))


@dataclass(frozen=True)
class PairSharding:
    """What JAX's ``pair_sharding`` tells the model (mesh.py:312-319): the
    graph axis that splits the pair tensors' receiver axis, and the model
    axis that splits the MLPs (size 1 on a 2-D mesh)."""
    graph: Axis
    model: Axis


def _run(kind: str, tensor: torch.Tensor, fn, *args, **kwargs) -> None:
    sync = tensor.is_cuda
    if sync:
        torch.cuda.synchronize(tensor.device)
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    if sync:
        torch.cuda.synchronize(tensor.device)
    stats[f"{kind}_s"] += time.perf_counter() - t0
    stats[f"{kind}_bytes"] += tensor.numel() * tensor.element_size()
    stats[f"{kind}_calls"] += 1


def _all_reduce_list(ax: Axis, tensors: List[Optional[torch.Tensor]]) -> list:
    """The sums over the axis of ``tensors`` (None stays None), by one
    all-reduce of one flat buffer: in their dtype when they share one (a
    bf16 sum of two ranks is the bf16 rounding of the exact sum), else in
    float32."""
    live = [t for t in tensors if t is not None]
    if ax.size == 1 or not live:
        return list(tensors)
    dtypes = {t.dtype for t in live}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    flat = torch.cat([t.reshape(-1).to(dtype) for t in live])
    _run("all_reduce", flat, dist.all_reduce, flat, group=ax.group)
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _all_gather(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    _run("all_gather", x, dist.all_gather, parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of ``dim`` of the sum over the axis of ``x``, in
    float32 (then ``x``'s dtype)."""
    parts = [p.to(torch.float32).contiguous() for p in x.chunk(ax.size, dim=dim)]
    out = torch.empty_like(parts[0])
    _run("reduce_scatter", x, dist.reduce_scatter, out, parts, group=ax.group)
    return out.to(x.dtype)


def _part(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    size = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_all_reduce_list(ctx.ax, list(grads)))


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        return _all_reduce_list(ax, [x])[0]

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return _all_reduce_list(ax, [x])[0]

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce_list(ctx.ax, [g])[0]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x, dim, shared):
        ctx.ax, ctx.dim, ctx.shared = ax, dim, shared
        return _all_gather(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.shared:
            return None, _reduce_scatter(ctx.ax, g, ctx.dim), None, None
        return None, _part(ctx.ax, g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x, dim):
        ctx.ax, ctx.dim = ax, dim
        return _part(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, _all_gather(ctx.ax, g, ctx.dim), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x, dim):
        ctx.ax, ctx.dim = ax, dim
        return _reduce_scatter(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, _all_gather(ctx.ax, g, ctx.dim), None


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, g if ctx.ax.rank == 0 else torch.zeros_like(g)


def copy_to(ax: Optional[Axis], *xs: torch.Tensor):
    """``xs`` unchanged; their gradients all-reduced over the axis, one
    flat buffer for all of them. One tensor in, one out."""
    if ax is None or ax.size == 1:
        return xs[0] if len(xs) == 1 else xs
    out = _CopyTo.apply(ax, *xs)
    return out[0] if len(xs) == 1 else out


def reduce_from(ax: Optional[Axis], x: torch.Tensor) -> torch.Tensor:
    return x if ax is None or ax.size == 1 else _ReduceFrom.apply(ax, x)


def all_reduce(ax: Optional[Axis], x: torch.Tensor) -> torch.Tensor:
    return x if ax is None or ax.size == 1 else _AllReduce.apply(ax, x)


def gather(ax: Optional[Axis], x: torch.Tensor, dim: int) -> torch.Tensor:
    return x if ax is None or ax.size == 1 else _Gather.apply(ax, x, dim, False)


def gather_shared(ax: Optional[Axis], x: torch.Tensor, dim: int) -> torch.Tensor:
    return x if ax is None or ax.size == 1 else _Gather.apply(ax, x, dim, True)


def scatter(ax: Optional[Axis], x: torch.Tensor, dim: int) -> torch.Tensor:
    return x if ax is None or ax.size == 1 else _Scatter.apply(ax, x, dim)


def reduce_scatter(ax: Optional[Axis], x: torch.Tensor, dim: int) -> torch.Tensor:
    return x if ax is None or ax.size == 1 else _ReduceScatter.apply(ax, x, dim)


def once(ax: Optional[Axis], x: torch.Tensor) -> torch.Tensor:
    return x if ax is None or ax.size == 1 else _Once.apply(ax, x)
