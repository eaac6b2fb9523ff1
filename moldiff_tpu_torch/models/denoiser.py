"""NodeEdgeNet denoiser on dense padded complete graphs, forward only
(moldiff_tpu/models/denoiser.py).

Edges live in a dense ``[B, N, N, H]`` tensor where (i, j) is the directed
edge i <- j; padding is handled by a pair mask (both endpoints real, i != j)
and masked pairs contribute exactly zero to every sum.

The port runs the JAX package's kernel path (``use_pallas`` + ``pallas_bwd``
with ``edge_full=False``): the NodeBlock message sum, the EdgeBlock pair
aggregate and the PosUpdate force sum go through the wrappers of
ops/kernels.py, which launch the CUDA kernels for CUDA tensors and use
their plain versions for CPU tensors. Everything around them (embeddings,
LayerNorms, the edge tail) is plain PyTorch in the compute dtype, as the
JAX package leaves it to XLA. The gated blocks (``use_gate: true``, every
committed model) are the ones with kernels; an ungated model is refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import kernels
from .nn import GaussianSmearing, layernorm, linear, linear_parts, safe_distance

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def denoiser_static_config(num_blocks: int, cutoff: float, use_gate: bool,
                           update_edge: bool = True, update_pos: bool = True,
                           num_gaussians: int = 16, start: float = 0.0,
                           dtype: str = "float32", moe=None, **_unused) -> dict:
    """Static architecture config (denoiser.py:339-394). The JAX package's
    kernel and memory knobs (use_pallas, pallas_bwd, fuse_*, remat) are
    accepted and ignored: the port has one path."""
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
        "smearing": GaussianSmearing(start=start, stop=cutoff,
                                     num_gaussians=num_gaussians, type_="exp"),
    }


def compute_dtype(static: dict) -> torch.dtype:
    return _DTYPES[static.get("dtype", "float32")]


def node_block(p, x, edge_attr, node_time, pair_mask):
    """NodeBlock (denoiser.py:65-145, use_pallas path): kernel message sum,
    then centroid linear, LN, relu, out."""
    aggr = kernels.node_block_aggregate(
        {k: p[k] for k in ("node_net", "edge_net", "msg_net", "gate")},
        x, edge_attr, node_time, pair_mask)
    out = linear(p["centroid_lin"], x) + aggr
    out = layernorm(p["ln"], out)
    return linear(p["out"], torch.relu(out))


def edge_block(p, h_bond, h_node, bond_time, pair_mask):
    """EdgeBlock (denoiser.py:219-253, pallas_bwd partial path): kernel pair
    aggregate, then the node/self FFNs, LN, relu, out."""
    t_pn, u_pn = kernels.edge_pair_aggregate(
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


def apply_block(blk, static, h_node, pos_node, h_edge, node_time, edge_time, pair_mask,
                dist0=None):
    """One block: edge embed -> NodeBlock -> EdgeBlock -> PosUpdate, all
    residual (denoiser.py:481-597). Inputs are in the compute dtype."""
    update_edge, update_pos = static["update_edge"], static["update_pos"]
    if update_pos or dist0 is None:
        h_dist, rel_vec, distance = dist_features(pos_node, static, h_edge.dtype)
    else:
        h_dist, rel_vec, distance = dist0
    if update_edge:
        h_edge_i = linear_parts(blk["edge_emb"], (h_edge, h_dist),
                                (h_edge.shape[-1], h_dist.shape[-1]))
    else:
        h_edge_i = linear(blk["edge_emb"], h_dist)
    h_node_delta = node_block(blk["node_block"], h_node, h_edge_i, node_time, pair_mask)
    if update_edge:
        h_edge_i = h_edge_i + edge_block(blk["edge_block"], h_edge_i, h_node, edge_time,
                                         pair_mask)
    h_node = h_node + h_node_delta
    if update_pos:
        # PosUpdate (denoiser.py:324-336, pallas_bwd path) is the kernel alone
        pos_node = pos_node + kernels.pos_update(blk["pos_block"], h_node, h_edge_i, rel_vec,
                                                 distance, edge_time, pair_mask)
    return h_node, pos_node, h_edge_i


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def prepare_blocks(params: dict, static: dict) -> list:
    """Stacked block params (leading ``num_blocks`` axis, float32) -> a list
    of per-block trees in the compute dtype. The JAX forward casts every
    float32 leaf to the compute dtype first (denoiser.py:631-635); this does
    the same once, so a sampler can reuse the result at every step."""
    dt = compute_dtype(static)
    cast = _tree_map(lambda x: x.to(dt) if x.dtype == torch.float32 else x, params["blocks"])
    return [_tree_map(lambda x, k=k: x[k], cast) for k in range(static["num_blocks"])]


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
