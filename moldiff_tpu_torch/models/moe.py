"""Mixture-of-experts MLP with token-choice routing
(moldiff_tpu/models/moe.py:36-140).

``model.denoiser.moe: {num_experts: E, ...}`` swaps the NodeBlock's per-atom
MLP for a routed bank of E expert MLPs. Routing, ranking and the capacity
masks are fixed-shape one-hot tensors, dispatch and combine are products
(``[S,E,C] x [S,D] -> [E,C,D]``), as in the JAX package (GShard / Switch
dense dispatch): the JAX package computes them with ``einsum`` outside any
Pallas kernel, and so does the port.

Padded atoms are never routed (their gate and dispatch are zero and they
take no expert capacity); tokens over an expert's capacity are dropped
(zero delta; the NodeBlock's residual carries them). Routing runs in
float32 whatever the compute dtype. The parameter layout is JAX's: a
bias-free router ``[din, E]`` and the experts' MLP leaves stacked on a
leading expert axis.

On a mesh (``cfg["comm"]``, a :class:`MoEComm` the trainer sets) the layer
computes what JAX's GSPMD computes over the global tokens while each rank
holds its data shard's rows:

- the data axis: the capacity comes from the global token count; a token's
  capacity position is its local running count plus those of the lower
  data ranks, first choices ahead of every second choice (one all-gather
  of each rank's per-expert counts per choice and of its real tokens); the
  load-balance loss is returned as this rank's share of the global one
  (the global first-choice shares f times this rank's sum of router
  probabilities over the global real-token count), so that the shares
  summed over the data ranks are JAX's loss and its gradient;
- the expert axis: the tokens of a data shard are replicated over
  ``expert``; this rank holds E / n_expert of the experts (the trainer's
  shards, ``ep_param_sharding``) and runs them on their dispatch slots,
  and the combine partials are summed over the expert group. The tokens
  and gates enter the expert region through an identity whose backward
  sums over the group, and the partials leave it through a sum whose
  backward is the identity (Megatron's pair), so every rank's gradient of
  the router and of every replicated leaf is the whole one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import tree_map
from .nn import init_linear, init_mlp, mlp


@dataclass(frozen=True)
class MoEComm:
    """This rank's place for :func:`moe_mlp`: its data coordinate of
    ``n_data`` and the data group, its expert coordinate of ``n_expert``
    and the expert group (None: the whole world)."""
    n_data: int = 1
    data_rank: int = 0
    data_group: Any = None
    n_expert: int = 1
    expert_rank: int = 0
    expert_group: Any = None


class _ToExperts(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.to(torch.float32).contiguous()
        dist.all_reduce(out, group=ctx.group)
        return out.to(g.dtype), None


class _FromExperts(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def normalize_moe_cfg(moe) -> Optional[dict]:
    """A config's ``moe:`` block -> a plain dict with JAX's defaults
    (moe.py:36-51): 4 experts, top-1, capacity factor 1.25, aux weight
    0.01; None when the block is absent or empty."""
    if not moe:
        return None
    get = moe.get if hasattr(moe, "get") else lambda k, d=None: d
    cfg = {
        "num_experts": int(get("num_experts", 4)),
        "top_k": int(get("top_k", 1)),
        "capacity_factor": float(get("capacity_factor", 1.25)),
        "aux_weight": float(get("aux_weight", 0.01)),
    }
    if cfg["top_k"] not in (1, 2):
        raise ValueError(f"moe.top_k must be 1 or 2, got {cfg['top_k']}")
    if cfg["num_experts"] < 2:
        raise ValueError("moe.num_experts must be >= 2")
    return cfg


def init_moe_mlp(generator: torch.Generator, din: int, dout: int, hidden: int,
                 num_experts: int, device: "str | torch.device" = "cpu") -> dict:
    """The expert bank that replaces one ``init_mlp`` (moe.py:54-68): a
    bias-free router (din -> E) and E expert MLPs stacked on a leading
    expert axis."""
    router = init_linear(generator, din, num_experts, bias=False, device=device)
    experts = [init_mlp(generator, din, dout, hidden, device=device) for _ in range(num_experts)]
    return {"router": router, "experts": tree_map(lambda *xs: torch.stack(xs), *experts)}


def choose(probs: torch.Tensor, top_k: int) -> List[torch.Tensor]:
    """Each token's experts [S], first choice first (moe.py:92-103): the
    most probable, and with top-2 the most probable of the others."""
    idx1 = torch.argmax(probs, dim=-1)
    if top_k == 1:
        return [idx1]
    rest = probs * (1.0 - torch.nn.functional.one_hot(idx1, probs.shape[-1]).float())
    return [idx1, torch.argmax(rest, dim=-1)]


def gates(probs: torch.Tensor, mask: torch.Tensor,
          choices: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The selections of ``choices``, one-hot [S, E] float32 zeroed at padded
    tokens, and their gates [S] (moe.py:94-111): with two choices the two
    gates are renormalised to sum to 1."""
    sels = [torch.nn.functional.one_hot(idx, probs.shape[-1]).float() * mask[:, None]
            for idx in choices]
    out = [torch.sum(probs * sel, dim=-1) for sel in sels]
    if len(out) == 2:
        denom = out[0] + out[1] + 1e-9
        out = [out[0] / denom, out[1] / denom]
    return sels, out


def _expert_mlp(experts: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The E expert MLPs on their own slots: x [E, C, D] -> [E, C, dout]
    (``jax.vmap(mlp)`` over the leading axis). ``tp``: the model axis
    their hidden width is split over (``experts`` a ShardedMLP)."""
    return mlp(tree_map(lambda w: w[:, None] if w.dim() == 2 else w, experts), x, tp)


def _global_counts(sels: List[torch.Tensor], mask: torch.Tensor,
                   comm: Optional[MoEComm]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the lower data ranks' per-expert counts [k, E], the global ones
    [k, E], the global real-token count) of the choices ``sels``: zeros,
    the local counts and the local count without a data axis."""
    local = torch.cat([torch.stack([torch.sum(sel, dim=0) for sel in sels]).reshape(-1),
                       torch.sum(mask).reshape(1)])
    if comm is None or comm.n_data == 1:
        every = local[None]
        rank = 0
    else:
        parts = [torch.empty_like(local) for _ in range(comm.n_data)]
        dist.all_gather(parts, local, group=comm.data_group)
        every, rank = torch.stack(parts), comm.data_rank
    lower, total = every[:rank].sum(0), every.sum(0)
    shape = (len(sels), -1)
    return lower[:-1].reshape(shape), total[:-1].reshape(shape), total[-1]


def moe_mlp(p: dict, x: torch.Tensor, node_mask: torch.Tensor, cfg: dict, tp=None):
    """Routed expert MLP (moe.py:71-140). x [B, N, D] in the compute dtype,
    node_mask [B, N] (1 = real atom) -> (y [B, N, dout], aux).

    ``aux`` is the Switch load-balance loss E * sum_e f_e * P_e over real
    tokens (f_e: the share whose first choice is e, P_e: the mean router
    probability), 1.0 at perfect balance. First choices take capacity
    before second choices (GShard); over-capacity tokens are dropped.
    ``cfg["comm"]`` (a :class:`MoEComm`, optional): this rank's place on a
    data and an expert axis, as the module docstring says; ``aux`` is then
    this rank's share of the global loss, and ``p["experts"]`` holds this
    rank's experts. ``tp``: the model axis (parallel/collectives.py Axis)
    that the experts' hidden width is split over, as any MLP's
    (models/nn.py ShardedMLP; the router stays replicated)."""
    b, n, d = x.shape
    s = b * n
    comm = cfg.get("comm")
    n_data = comm.n_data if comm is not None else 1
    num_experts = p["router"]["w"].shape[-1]
    top_k = cfg["top_k"]
    capacity = max(1, int(math.ceil(cfg["capacity_factor"] * top_k * s * n_data
                                    / num_experts)))
    tokens = x.reshape(s, d)
    mask = node_mask.reshape(s).to(torch.float32)

    logits = tokens.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    sels, token_gates = gates(probs, mask, choose(probs, top_k))
    lower, total, n_real = _global_counts(sels, mask, comm)
    experts = None
    if comm is not None and comm.n_expert > 1:
        experts = slice(comm.expert_rank * num_experts // comm.n_expert,
                        (comm.expert_rank + 1) * num_experts // comm.n_expert)
        token_gates = [_ToExperts.apply(g, comm.expert_group) for g in token_gates]

    dispatch = torch.zeros((s, num_experts, capacity), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    # the global positions: first choices ahead of every second choice, and
    # the lower data ranks' tokens ahead of this rank's (moe.py:115-118)
    offset = torch.zeros((num_experts,), dtype=torch.float32, device=x.device)
    for i, (sel, gate) in enumerate(zip(sels, token_gates)):
        position = torch.cumsum(sel, dim=0) - 1.0 + (offset + lower[i])[None, :]
        offset = offset + total[i]
        pos_int = torch.sum(position * sel, dim=-1).to(torch.int64)
        # jax.nn.one_hot of an index outside [0, C) is all zeros
        within = torch.nn.functional.one_hot(pos_int.clamp(0, capacity),
                                             capacity + 1)[:, :capacity]
        keep = (pos_int < capacity).to(torch.float32)
        d_k = sel[:, :, None] * within.float()[:, None, :] * keep[:, None, None]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[:, None, None]

    dt = x.dtype
    if experts is not None:
        dispatch, combine = dispatch[:, experts], combine[:, experts]
        tokens = _ToExperts.apply(tokens, comm.expert_group)
    expert_in = torch.einsum("sec,sd->ecd", dispatch.to(dt), tokens)
    expert_out = _expert_mlp(p["experts"], expert_in, tp)
    if experts is None:
        y = torch.einsum("sec,ech->sh", combine.to(dt), expert_out)
    else:
        # the partials in float32 from the compute dtype's products, rounded
        # once after the sum, as the one product over all experts rounds
        f32 = torch.float32
        y = torch.einsum("sec,ech->sh", combine.to(dt).to(f32), expert_out.to(f32))
        y = _FromExperts.apply(y, comm.expert_group).to(dt)

    # this rank's share of the global loss: f global, P's sum this rank's
    n_real = torch.clamp(n_real, min=1.0)
    f = total[0] / n_real
    pbar = torch.sum(probs * mask[:, None], dim=0) / n_real
    aux = num_experts * torch.sum(f * pbar)
    return y.reshape(b, n, -1), aux
