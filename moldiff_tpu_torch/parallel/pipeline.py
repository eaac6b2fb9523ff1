"""GPipe over the denoiser's stacked blocks (moldiff_tpu/parallel/pipeline.py).

The denoiser's per-block params are stacked on a leading ``num_blocks``
axis, so a ``pipe`` axis of P stages splits that axis: stage s holds blocks
``[s * k, (s + 1) * k)``, k = num_blocks / P (:func:`pipe_param_sharding`).
Within each data shard the batch is cut into M microbatches that stream
through the stages, JAX's schedule of M + P - 1 ticks:

  tick t:  stage s runs its blocks on microbatch t - s (when 0 <= t - s < M):
           stage 0 takes it from the inputs, every other stage receives the
           carry (h_node, pos, h_edge) from stage s - 1, and every stage but
           the last sends its result on to stage s + 1.

The last stage holds the outputs and broadcasts them over the pipe group,
so they are replicated over ``pipe`` as JAX's masked ``psum`` leaves them.

Each rank is one process; the carry moves by ``torch.distributed`` send and
recv between the ranks d * P + s and d * P + s + 1. NCCL sends CUDA tensors
as they are; gloo sends host tensors only, so with gloo and a card the
carry is staged through host buffers (two ranks that share one card run
over gloo: NCCL refuses two ranks on one device).

The backward is an explicit GPipe schedule, not autograd through send and
recv (the autograd engine's order could then differ between ranks and
deadlock them): the forward keeps each stage's graph per microbatch, and
the backward walks the ticks in reverse, each stage calling
``torch.autograd.backward`` on its outputs of one microbatch with the
cotangents received from the next stage (the last stage: its own
cotangents of the replicated output) and sending its inputs' cotangents to
the previous stage. The output's cotangent is taken on the last stage
alone: every pipe rank computes the same loss from the replicated output,
and each gradient is counted once. Stage 0 returns the inputs' cotangents
(the embedders' gradients exist on stage 0 only); the other stages return
zeros. The block params' gradients come out on the stage that holds them.

Every block runs the port's ``apply_block`` (models/denoiser.py) with the
model's static config, so the kernels of its route run in every stage on
its microbatches.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .mesh import PIPE_AXIS, Mesh, flatten, pipe_placement, replicated, unflatten

# host-side seconds and bytes of the pipe's transfers since the last reset:
# the carry's and cotangents' sends and receives (their host staging and the
# wait for the peer included) and the output's broadcast
stats = {"p2p_s": 0.0, "p2p_bytes": 0, "broadcast_s": 0.0}


def reset_stats() -> None:
    stats.update(p2p_s=0.0, p2p_bytes=0, broadcast_s=0.0)


def pipe_param_sharding(mesh: "Mesh | int", tree: Any) -> Any:
    """JAX's pipe placement (pipeline.py:53-87) as a tree of Placement:
    every leaf under a ``blocks`` key is split on dim 0 over ``pipe`` when
    that dimension divides by the axis; every other leaf is replicated.
    ``mesh``: a Mesh or the pipe axis's size."""
    n = mesh if isinstance(mesh, int) else (mesh.pipe if PIPE_AXIS in mesh.axes else 1)

    def walk(node):
        if isinstance(node, dict):
            return {k: (tree_map(lambda x: pipe_placement(x.shape, n), v)
                        if k == "blocks" and n > 1 else walk(v)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return replicated(node.shape)

    return walk(tree)


def _choose_microbatches(batch_local: int, requested: Optional[int], n_pipe: int) -> int:
    """The largest divisor of the per-data-shard batch that is at most the
    request (default P, the canonical GPipe choice) (pipeline.py:90-98)."""
    target = requested if requested else n_pipe
    m = max(1, min(int(target), batch_local))
    while batch_local % m != 0:
        m -= 1
    return m


def _staged(mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def _send(mesh: Mesh, tensors: List[torch.Tensor], dst: int) -> None:
    t0 = time.perf_counter()
    for t in tensors:
        t = t.detach().contiguous()
        if _staged(mesh):
            t = t.cpu()
        dist.send(t, dst)
        stats["p2p_bytes"] += t.numel() * t.element_size()
    stats["p2p_s"] += time.perf_counter() - t0


def _recv(mesh: Mesh, like: List[torch.Tensor], src: int) -> List[torch.Tensor]:
    t0 = time.perf_counter()
    out = []
    for t in like:
        buf = torch.empty(t.shape, dtype=t.dtype,
                          device="cpu" if _staged(mesh) else t.device)
        dist.recv(buf, src)
        out.append(buf.to(t.device))
    stats["p2p_s"] += time.perf_counter() - t0
    return out


class _Schedule:
    """What one pipelined forward needs besides the differentiable inputs."""

    def __init__(self, static: dict, mesh: Mesh, blocks: Any, n_micro: int,
                 node_time, edge_time, pair_mask):
        self.static, self.mesh, self.n_micro = static, mesh, n_micro
        self.blocks = blocks              # the stage's stacked block tree (structure)
        self.node_time, self.edge_time, self.pair_mask = node_time, edge_time, pair_mask
        self.stage, self.n_pipe = mesh.coord(PIPE_AXIS), mesh.size(PIPE_AXIS)
        # whether a backward may follow: else no stage keeps its graphs
        self.keep = torch.is_grad_enabled()

    def active(self, tick: int) -> Optional[int]:
        """The microbatch this stage runs at ``tick``, or None."""
        m = tick - self.stage
        return m if 0 <= m < self.n_micro else None

    def rank(self, stage: int) -> int:
        return self.mesh.group_rank(PIPE_AXIS, stage)


class _Pipeline(torch.autograd.Function):
    """(h_node, pos, h_edge, *stage block leaves) -> the denoiser's
    (h_node, pos, h_edge), replicated over pipe."""

    @staticmethod
    def forward(ctx, sched: _Schedule, h_node, pos, h_edge, *leaves):
        from ..models.denoiser import apply_block, compute_dtype

        static, dt = sched.static, compute_dtype(sched.static)
        s, n_pipe, n_micro = sched.stage, sched.n_pipe, sched.n_micro
        mb = h_node.shape[0] // n_micro
        params = [x.detach().requires_grad_(sched.keep) for x in leaves]
        with torch.set_grad_enabled(sched.keep):
            tree = tree_map(lambda x: x.to(dt) if x.dtype == torch.float32 else x,
                            tree_unflatten(sched.blocks, params))
            k = tree_leaves(tree)[0].shape[0]
            blocks = [tree_map(lambda x, j=j: x[j], tree) for j in range(k)]
        ins: List[Optional[list]] = [None] * n_micro
        outs: List[Optional[tuple]] = [None] * n_micro
        like = [h_node[:mb].to(dt), pos[:mb], h_edge[:mb].to(dt)]
        for tick in range(n_micro + n_pipe - 1):
            m = sched.active(tick)
            if m is None:
                continue
            rows = slice(m * mb, (m + 1) * mb)
            if s == 0:
                x = [h_node[rows].to(dt), pos[rows], h_edge[rows].to(dt)]
            else:
                x = _recv(sched.mesh, like, sched.rank(s - 1))
            x = [t.detach().requires_grad_(sched.keep) for t in x]
            with torch.set_grad_enabled(sched.keep):
                h, p, e = x
                for blk in blocks:
                    h, p, e, _ = apply_block(blk, static, h, p, e, sched.node_time[rows],
                                             sched.edge_time[rows], sched.pair_mask[rows])
            ins[m], outs[m] = x, (h, p, e)
            if not sched.keep:
                outs[m] = tuple(t.detach() for t in outs[m])
            if s < n_pipe - 1:
                _send(sched.mesh, [h, p, e], sched.rank(s + 1))
        result = [h_node.new_empty(h_node.shape), pos.new_empty(pos.shape),
                  h_edge.new_empty(h_edge.shape)]
        if s == n_pipe - 1:
            result = [torch.cat([o[i].detach() for o in outs]).to(r.dtype)
                      for i, r in enumerate(result)]
        if n_pipe > 1:
            t0 = time.perf_counter()
            flat = flatten(result)
            dist.broadcast(flat, sched.rank(n_pipe - 1), group=sched.mesh.group(PIPE_AXIS))
            result = unflatten(flat, result)
            stats["broadcast_s"] += time.perf_counter() - t0
        ctx.sched, ctx.ins, ctx.outs, ctx.params = sched, ins, outs, params
        ctx.in_dtypes = (h_node.dtype, pos.dtype, h_edge.dtype)
        return tuple(result)

    @staticmethod
    def backward(ctx, g_h, g_pos, g_e):
        sched, ins, outs, params = ctx.sched, ctx.ins, ctx.outs, ctx.params
        s, n_pipe, n_micro = sched.stage, sched.n_pipe, sched.n_micro
        mb = g_h.shape[0] // n_micro
        grads_in: List[Optional[list]] = [None] * n_micro
        for tick in reversed(range(n_micro + n_pipe - 1)):
            m = sched.active(tick)
            if m is None:
                continue
            out = outs[m]
            if s == n_pipe - 1:
                rows = slice(m * mb, (m + 1) * mb)
                g = [g[rows].to(o.dtype) for g, o in zip((g_h, g_pos, g_e), out)]
            else:
                g = _recv(sched.mesh, [o.detach() for o in out], sched.rank(s + 1))
            torch.autograd.backward(out, g, retain_graph=True)
            gx = [t.grad if t.grad is not None else torch.zeros_like(t) for t in ins[m]]
            outs[m] = ins[m] = None
            if s > 0:
                _send(sched.mesh, gx, sched.rank(s - 1))
            else:
                grads_in[m] = gx
        if s == 0:
            g_in = [torch.cat([g[i] for g in grads_in]).to(dtype)
                    for i, dtype in enumerate(ctx.in_dtypes)]
        else:
            g_in = [torch.zeros(g.shape, dtype=dtype, device=g.device)
                    for g, dtype in zip((g_h, g_pos, g_e), ctx.in_dtypes)]
        g_params = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        ctx.ins = ctx.outs = ctx.params = None
        return (None, *g_in, *g_params)


def pipeline_denoiser(params: dict, static: dict, h_node: torch.Tensor, pos_node: torch.Tensor,
                      h_edge: torch.Tensor, node_time: torch.Tensor, edge_time: torch.Tensor,
                      pair_mask: torch.Tensor, mesh: Mesh,
                      num_microbatches: Optional[int] = None):
    """The pipelined NodeEdgeNet forward (pipeline.py:101-226) on this
    rank's rows of the batch (its data shard): [b, N, Dn], [b, N, 3],
    [b, N, N, De], times [b, 1, 1], pair mask [b, N, N] -> (h_node, pos,
    h_edge), the same on every rank of this rank's pipe group.

    ``params`` is this stage's denoiser tree ``{"blocks": stacked}``, its
    k = num_blocks / P blocks (the trainer's shards at rest).
    ``num_microbatches``: the request of :func:`_choose_microbatches`. The
    port keeps every block's activations (JAX's ``remat`` has no
    counterpart)."""
    if static.get("moe") is not None:
        raise ValueError(
            "pipeline parallelism does not support MoE denoisers (the "
            "tick loop carries no aux scalar); use the 'expert' mesh axis")
    assert PIPE_AXIS in mesh.axes, "mesh has no 'pipe' axis"
    n_pipe = mesh.size(PIPE_AXIS)
    blocks = params["blocks"]
    num_blocks = static["num_blocks"]
    assert num_blocks % n_pipe == 0, f"num_blocks={num_blocks} not divisible by pipe={n_pipe}"
    assert tree_leaves(blocks)[0].shape[0] == num_blocks // n_pipe, "not this stage's blocks"
    n_micro = _choose_microbatches(h_node.shape[0], num_microbatches, n_pipe)
    sched = _Schedule(static, mesh, blocks, n_micro, node_time, edge_time, pair_mask)
    return _Pipeline.apply(sched, h_node, pos_node, h_edge, *tree_leaves(blocks))
