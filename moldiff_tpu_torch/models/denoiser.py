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
from .nn import GaussianSmearing, layernorm, linear, linear_parts, safe_distance

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
