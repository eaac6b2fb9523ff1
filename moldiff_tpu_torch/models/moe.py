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
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from ..utils.tree import tree_map
from .nn import init_linear, init_mlp, mlp


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


def _expert_mlp(experts: dict, x: torch.Tensor) -> torch.Tensor:
    """The E expert MLPs on their own slots: x [E, C, D] -> [E, C, dout]
    (``jax.vmap(mlp)`` over the leading axis)."""
    return mlp(tree_map(lambda w: w[:, None] if w.dim() == 2 else w, experts), x)


def moe_mlp(p: dict, x: torch.Tensor, node_mask: torch.Tensor, cfg: dict):
    """Routed expert MLP (moe.py:71-140). x [B, N, D] in the compute dtype,
    node_mask [B, N] (1 = real atom) -> (y [B, N, dout], aux).

    ``aux`` is the Switch load-balance loss E * sum_e f_e * P_e over real
    tokens (f_e: the share whose first choice is e, P_e: the mean router
    probability), 1.0 at perfect balance. First choices take capacity
    before second choices (GShard); over-capacity tokens are dropped."""
    b, n, d = x.shape
    s = b * n
    num_experts = p["router"]["w"].shape[-1]
    top_k = cfg["top_k"]
    capacity = max(1, int(math.ceil(cfg["capacity_factor"] * top_k * s / num_experts)))
    tokens = x.reshape(s, d)
    mask = node_mask.reshape(s).to(torch.float32)

    logits = tokens.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    sels, token_gates = gates(probs, mask, choose(probs, top_k))

    dispatch = torch.zeros((s, num_experts, capacity), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    offset = torch.zeros((num_experts,), dtype=torch.float32, device=x.device)
    for sel, gate in zip(sels, token_gates):
        position = torch.cumsum(sel, dim=0) - 1.0 + offset[None, :]
        offset = offset + torch.sum(sel, dim=0)
        pos_int = torch.sum(position * sel, dim=-1).to(torch.int64)
        # jax.nn.one_hot of an index outside [0, C) is all zeros
        within = torch.nn.functional.one_hot(pos_int.clamp(0, capacity),
                                             capacity + 1)[:, :capacity]
        keep = (pos_int < capacity).to(torch.float32)
        d_k = sel[:, :, None] * within.float()[:, None, :] * keep[:, None, None]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[:, None, None]

    dt = x.dtype
    expert_in = torch.einsum("sec,sd->ecd", dispatch.to(dt), tokens)
    expert_out = _expert_mlp(p["experts"], expert_in)
    y = torch.einsum("sec,ech->sh", combine.to(dt), expert_out)

    n_real = torch.clamp(torch.sum(mask), min=1.0)
    f = torch.sum(sels[0], dim=0) / n_real
    pbar = torch.sum(probs * mask[:, None], dim=0) / n_real
    aux = num_experts * torch.sum(f * pbar)
    return y.reshape(b, n, -1), aux
