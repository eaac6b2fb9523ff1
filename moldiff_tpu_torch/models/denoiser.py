"""NodeEdgeNet denoiser on dense padded complete graphs
(moldiff_tpu/models/denoiser.py).

Edges live in a dense ``[B, N, N, H]`` tensor where (i, j) is the directed
edge i <- j; padding is handled by a pair mask (both endpoints real, i != j)
and masked pairs contribute exactly zero to every sum.

The port runs the JAX package's kernel path (``use_pallas`` + ``pallas_bwd``
are implied: the port has no other), with its two route knobs as
denoiser.py:235-244 and :521-535 read them:

- by default (the partial path) the NodeBlock message sum, the EdgeBlock
  pair aggregate and the PosUpdate force sum go through the wrappers of
  ops/kernels.py (rows 1, 4, 8 of the kernel table forward; 3, 5, 9
  backward); everything around them (edge embedding, LayerNorms, the edge
  tail, residuals) is plain PyTorch in the compute dtype, as the JAX
  package leaves it to XLA;
- ``edge_full: true`` runs the whole EdgeBlock (both chains, their sums and
  the tail) as one kernel, forward and backward (rows 6 and 7);
- ``fuse_block: true`` runs a block that updates edges and positions as
  one whole-block kernel (row 2), with the node time as its one time input;
  its gradient is that of the partial path's block (rows 1, 4, 8 recomputed,
  3, 5, 9 backward), as pallas_kernels.py:_fb_bwd takes it from
  _xla_fused_block. It takes precedence over ``edge_full``; the bond
  predictor (``update_pos: false``) never takes it.

The wrappers launch the CUDA kernels for CUDA tensors and use their plain
versions for CPU tensors. The gated blocks (``use_gate: true``, every
committed model) are the ones with kernels; an ungated model is refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import kernels
from ..utils.tree import tree_map
from .nn import (GaussianSmearing, init_layernorm, init_linear, init_mlp, layernorm, linear,
                 linear_parts, safe_distance)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def denoiser_static_config(num_blocks: int, cutoff: float, use_gate: bool,
                           update_edge: bool = True, update_pos: bool = True,
                           num_gaussians: int = 16, start: float = 0.0,
                           dtype: str = "float32", edge_full: bool = False,
                           fuse_block: bool = False, moe=None, **_unused) -> dict:
    """Static architecture config (denoiser.py:378-431). ``edge_full`` and
    ``fuse_block`` choose the route as in the JAX package; its other kernel
    and memory knobs (use_pallas, pallas_bwd, fuse_edge, remat) are
    accepted and ignored: the port always takes the kernel path."""
    if not use_gate:
        raise NotImplementedError("the port runs gated denoisers (use_gate: true) only")
    if moe:
        raise NotImplementedError("MoE denoisers are not ported yet")
    return {
        "num_blocks": num_blocks,
        "cutoff": float(cutoff),
        "update_edge": update_edge,
        "update_pos": update_pos,
        "num_gaussians": num_gaussians,
        "start": float(start),
        "dtype": dtype,
        "edge_full": bool(edge_full),
        "fuse_block": bool(fuse_block),
        "smearing": GaussianSmearing(start=start, stop=cutoff,
                                     num_gaussians=num_gaussians, type_="exp"),
    }


def compute_dtype(static: dict) -> torch.dtype:
    return _DTYPES[static.get("dtype", "float32")]


# -- initialisation (the JAX package's trees; models/nn.py's rule) ---------------
# Every block is gated: denoiser_static_config refuses use_gate: false.

def init_node_block(gen, node_dim, edge_dim, hidden_dim, device):
    """denoiser.py:51-69."""
    return {
        "node_net": init_mlp(gen, node_dim, hidden_dim, hidden_dim, device=device),
        "edge_net": init_mlp(gen, edge_dim, hidden_dim, hidden_dim, device=device),
        "msg_net": init_linear(gen, hidden_dim, hidden_dim, device=device),
        "centroid_lin": init_linear(gen, node_dim, hidden_dim, device=device),
        "ln": init_layernorm(hidden_dim, device),
        "out": init_linear(gen, hidden_dim, node_dim, device=device),
        "gate": init_mlp(gen, edge_dim + node_dim + 1, hidden_dim, hidden_dim, device=device),
    }


def init_bond_ffn(gen, bond_dim, node_dim, inter_dim, device, out_dim=None):
    """denoiser.py:150-160."""
    out_dim = bond_dim if out_dim is None else out_dim
    return {
        "bond_linear": init_linear(gen, bond_dim, inter_dim, bias=False, device=device),
        "node_linear": init_linear(gen, node_dim, inter_dim, bias=False, device=device),
        "inter": init_mlp(gen, inter_dim, out_dim, inter_dim, device=device),
        "gate": init_mlp(gen, bond_dim + node_dim + 1, out_dim, 32, device=device),
    }


def init_edge_block(gen, edge_dim, node_dim, device):
    """denoiser.py:198-210."""
    inter_dim = edge_dim * 2
    return {
        "bond_ffn_left": init_bond_ffn(gen, edge_dim, node_dim, inter_dim, device),
        "bond_ffn_right": init_bond_ffn(gen, edge_dim, node_dim, inter_dim, device),
        "node_ffn_left": init_linear(gen, node_dim, edge_dim, device=device),
        "node_ffn_right": init_linear(gen, node_dim, edge_dim, device=device),
        "self_ffn": init_linear(gen, edge_dim, edge_dim, device=device),
        "ln": init_layernorm(edge_dim, device),
        "out": init_linear(gen, edge_dim, edge_dim, device=device),
    }


def init_pos_update(gen, node_dim, edge_dim, hidden_dim, device):
    """denoiser.py:326-332."""
    return {
        "left_lin_edge": init_mlp(gen, node_dim, edge_dim, hidden_dim, device=device),
        "right_lin_edge": init_mlp(gen, node_dim, edge_dim, hidden_dim, device=device),
        "edge_lin": init_bond_ffn(gen, edge_dim, edge_dim, node_dim, device, out_dim=1),
    }


def init_node_edge_net(gen: torch.Generator, node_dim: int, edge_dim: int,
                       device: "str | torch.device", **denoiser_cfg):
    """(params, static config) with the blocks stacked on a leading
    ``num_blocks`` axis (denoiser.py:434-462): ``edge_emb`` reads
    [edge features || smeared distances] (the distances alone without
    ``update_edge``), ``edge_block`` exists with ``update_edge`` and
    ``pos_block`` with ``update_pos``."""
    static = denoiser_static_config(**denoiser_cfg)
    update_edge, update_pos = static["update_edge"], static["update_pos"]
    num_gaussians = static["num_gaussians"]
    input_edge_dim = edge_dim + num_gaussians if update_edge else num_gaussians
    blocks = []
    for _ in range(static["num_blocks"]):
        blk = {"node_block": init_node_block(gen, node_dim, edge_dim, node_dim, device),
               "edge_emb": init_linear(gen, input_edge_dim, edge_dim, device=device)}
        if update_edge:
            blk["edge_block"] = init_edge_block(gen, edge_dim, node_dim, device)
        if update_pos:
            blk["pos_block"] = init_pos_update(gen, node_dim, edge_dim, edge_dim, device)
        blocks.append(blk)
    return {"blocks": tree_map(lambda *leaves: torch.stack(leaves), *blocks)}, static


def node_block(p, x, edge_attr, node_time, pair_mask):
    """NodeBlock (denoiser.py:65-145, use_pallas + pallas_bwd path): kernel
    message sum (differentiable through the backward kernel), then centroid
    linear, LN, relu, out."""
    aggr = kernels.node_block_aggregate_ad(
        {k: p[k] for k in ("node_net", "edge_net", "msg_net", "gate")},
        x, edge_attr, node_time, pair_mask)
    out = linear(p["centroid_lin"], x) + aggr
    out = layernorm(p["ln"], out)
    return linear(p["out"], torch.relu(out))


def edge_block(p, h_bond, h_node, bond_time, pair_mask, edge_full: bool = False):
    """EdgeBlock (denoiser.py:219-253). With ``edge_full`` the whole block
    is one kernel, forward and backward (rows 6, 7); otherwise the partial
    path: the kernel pair aggregate (differentiable through its backward
    kernel), then the node/self FFNs, LN, relu, out."""
    if edge_full:
        return kernels.edge_block_full_ad(p, h_bond, h_node, bond_time, pair_mask)
    t_pn, u_pn = kernels.edge_pair_aggregate_ad(
        {"left": p["bond_ffn_left"], "right": p["bond_ffn_right"]},
        h_bond, h_node, bond_time, pair_mask)
    h = (t_pn[:, :, None, :] + u_pn[:, None, :, :]
         + linear(p["node_ffn_left"], h_node[:, :, None, :])
         + linear(p["node_ffn_right"], h_node[:, None, :, :])
         + linear(p["self_ffn"], h_bond))
    h = layernorm(p["ln"], h)
    return linear(p["out"], torch.relu(h))


def dist_features(pos_node, static, dtype):
    """(smeared distances in ``dtype``, rel vectors, distances), all pairs
    (denoiser.py:465-478)."""
    rel = pos_node[:, :, None, :] - pos_node[:, None, :, :]
    dist = safe_distance(rel)
    return static["smearing"](dist).to(dtype), rel, dist


def block_body(blk, static, h_node, h_edge, h_dist, rel_vec, distance, node_time, edge_time,
               pair_mask):
    """Edge embed -> NodeBlock -> EdgeBlock -> PosUpdate on given distance
    features, without the whole-block kernel -> (h_node, h_edge, the
    position delta or None)."""
    if static["update_edge"]:
        h_edge_i = linear_parts(blk["edge_emb"], (h_edge, h_dist),
                                (h_edge.shape[-1], h_dist.shape[-1]))
    else:
        h_edge_i = linear(blk["edge_emb"], h_dist)
    h_node_delta = node_block(blk["node_block"], h_node, h_edge_i, node_time, pair_mask)
    if static["update_edge"]:
        h_edge_i = h_edge_i + edge_block(blk["edge_block"], h_edge_i, h_node, edge_time,
                                         pair_mask, edge_full=static["edge_full"])
    h_node = h_node + h_node_delta
    pos_delta = None
    if static["update_pos"]:
        # PosUpdate (denoiser.py:338-350, pallas_bwd path) is the kernel alone,
        # differentiable through its backward kernel
        pos_delta = kernels.pos_update_ad(blk["pos_block"], h_node, h_edge_i, rel_vec, distance,
                                          edge_time, pair_mask)
    return h_node, h_edge_i, pos_delta


_PARTIAL = {"update_edge": True, "update_pos": True, "edge_full": False}


def fused_block_recompute(blk, h_node, h_edge, h_dist, rel_vec, distance, node_time, pair_mask):
    """What the whole-block kernel computes, by the partial path with the
    node time as both times: the gradient of the whole block
    (pallas_kernels.py:_fb_bwd differentiates _xla_fused_block)."""
    return block_body(blk, _PARTIAL, h_node, h_edge, h_dist, rel_vec, distance, node_time,
                      node_time, pair_mask)


def apply_block(blk, static, h_node, pos_node, h_edge, node_time, edge_time, pair_mask,
                dist0=None):
    """One block: edge embed -> NodeBlock -> EdgeBlock -> PosUpdate, all
    residual (denoiser.py:481-597). Inputs are in the compute dtype. With
    ``fuse_block`` a block that updates edges and positions is the
    whole-block kernel (denoiser.py:521-535)."""
    update_edge, update_pos = static["update_edge"], static["update_pos"]
    if update_pos or dist0 is None:
        h_dist, rel_vec, distance = dist_features(pos_node, static, h_edge.dtype)
    else:
        h_dist, rel_vec, distance = dist0
    if static["fuse_block"] and update_edge and update_pos:
        h_node, h_edge_i, pos_delta = kernels.fused_block_ad(
            blk, fused_block_recompute, h_node, h_edge, h_dist, rel_vec, distance, node_time,
            pair_mask)
        return h_node, pos_node + pos_delta, h_edge_i
    h_node, h_edge_i, pos_delta = block_body(blk, static, h_node, h_edge, h_dist, rel_vec,
                                             distance, node_time, edge_time, pair_mask)
    if pos_delta is not None:
        pos_node = pos_node + pos_delta
    return h_node, pos_node, h_edge_i


def prepare_blocks(params: dict, static: dict) -> list:
    """Stacked block params (leading ``num_blocks`` axis, float32) -> a list
    of per-block trees in the compute dtype. The JAX forward casts every
    float32 leaf to the compute dtype first (denoiser.py:631-635); this does
    the same once, so a sampler can reuse the result at every step."""
    dt = compute_dtype(static)
    cast = tree_map(lambda x: x.to(dt) if x.dtype == torch.float32 else x, params["blocks"])
    return [tree_map(lambda x, k=k: x[k], cast) for k in range(static["num_blocks"])]


def node_edge_net(params, static, h_node, pos_node, h_edge, node_time, edge_time,
                  pair_mask, blocks: Optional[list] = None):
    """Forward pass -> (h_node, pos_node, h_edge) (denoiser.py:600-666).

    ``blocks``: the output of :func:`prepare_blocks` for ``params``; made
    here when not given. A Python loop over blocks replaces ``lax.scan``.
    """
    dt = compute_dtype(static)
    in_dtype = h_node.dtype
    if blocks is None:
        blocks = prepare_blocks(params, static)
    h_node = h_node.to(dt)
    h_edge = h_edge.to(dt)
    dist0 = None if static["update_pos"] else dist_features(pos_node, static, dt)
    for blk in blocks:
        h_node, pos_node, h_edge = apply_block(blk, static, h_node, pos_node, h_edge,
                                               node_time, edge_time, pair_mask, dist0=dist0)
    return h_node.to(in_dtype), pos_node, h_edge.to(in_dtype)
