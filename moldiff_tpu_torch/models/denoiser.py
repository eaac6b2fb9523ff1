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
versions for CPU tensors.

The model variants take JAX's routes (denoiser.py:91-145, :234-246, :344,
:521-526, :564):

- ``moe``: the NodeBlock's per-atom MLP is a routed expert bank
  (models/moe.py) and the NodeBlock runs JAX's plain math (no kernel; JAX
  passes ``use_pallas and moe_cfg is None``); the EdgeBlock and PosUpdate
  kernels run as above; :func:`node_edge_net` also returns the blocks'
  mean load-balance loss;
- ``use_gate: false``: every block is JAX's plain math, run here in
  PyTorch in the compute dtype, since the kernels compute gated blocks only
  (JAX takes them only where ``"gate" in p``);
- ``fuse_block`` is switched off, silently, under either variant.

On a mesh with a graph axis (``pair_sharding``, parallel/mesh.py: JAX sets
it whenever the mesh has a ``graph`` axis, of any size) JAX turns the
kernels off (denoiser.py:521-527, :546-552, :576, :585) and runs its plain
route, gated or not, with GSPMD placing the collectives; so does the port
(:func:`node_edge_net_sharded`), with every collective written out
(parallel/collectives.py). No kernel of ops/kernels.py runs there. The
receiver axis (axis 1) of every [B, N, N, .] tensor is split over the G
graph ranks: rank g holds rows [g n_loc, (g + 1) n_loc), n_loc = ceil(N /
G); an N that does not divide is padded with receiver rows whose pair mask
is 0. Positions and node features stay replicated. Per block:

- the distances, their smearing and the edge embedding: the rank's rows;
- NodeBlock: the sum over senders is local; the rank's rows of the update
  are all-gathered;
- EdgeBlock: T (a sum over receivers) is a sum across the ranks of which
  each needs its own rows: a reduce-scatter; U (a sum over senders) is
  local, and every column needs it: an all-gather;
- PosUpdate: the force sum is local; the rank's rows of the position delta
  are all-gathered;
- after the last block the edge features' rows are all-gathered, so the
  decoders and the loss run replicated.

The gradient rule that keeps this right: a replicated tensor or parameter
that enters row-split work goes through ``copy_to`` (identity; its
gradient all-reduced over graph, since each rank's work saw only its
rows); a row-split tensor made replicated is all-gathered, its backward
taking the rank's slice; a sum across ranks is reduce-scattered, its
backward all-gathered. The denoiser's params all enter row-split work, so
they pass ``copy_to`` once at the entry (one all-reduce of their
gradients); the block's input node features and positions pass it once
per block, and the updated node features once more before PosUpdate.
Under this rule every parameter's gradient is whole and equal on every
graph rank, and the trainer sums only over ``data``: all-reducing the
gradients over ``graph`` as well would count the replicated work (the
embedders, the decoders, the loss) G times. With a model axis the MLPs
split over it (models/nn.py ShardedMLP) run as Megatron's pair inside
this route. Under ``moe`` the NodeBlock's expert bank (models/moe.py) runs
on the replicated node features, every node on every graph rank (the
capacity from the real N, not the padded rows), its experts' MLPs split
over model as the dense MLPs are; the router stays replicated. Its
load-balance loss is replicated work too, and passes ``collectives.once``
so that the graph axis's gradient sums count it once.
"""
from __future__ import annotations

from typing import Optional

import torch

import torch.nn.functional as F

from ..ops import kernels
from ..parallel import collectives
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .moe import init_moe_mlp, moe_mlp, normalize_moe_cfg
from .nn import (GaussianSmearing, init_layernorm, init_linear, init_mlp, layernorm, linear,
                 linear_parts, mlp, mlp_parts, safe_distance)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def denoiser_static_config(num_blocks: int, cutoff: float, use_gate: bool,
                           update_edge: bool = True, update_pos: bool = True,
                           num_gaussians: int = 16, start: float = 0.0,
                           dtype: str = "float32", edge_full: bool = False,
                           fuse_block: bool = False, moe=None, **_unused) -> dict:
    """Static architecture config (denoiser.py:378-431). ``edge_full`` and
    ``fuse_block`` choose the route as in the JAX package; ``moe`` is the
    expert bank's settings (models/moe.py, normalised); its other kernel
    and memory knobs (use_pallas, pallas_bwd, fuse_edge, remat) are
    accepted and ignored: the port always takes the kernel path."""
    return {
        "num_blocks": num_blocks,
        "cutoff": float(cutoff),
        "use_gate": bool(use_gate),
        "update_edge": update_edge,
        "update_pos": update_pos,
        "num_gaussians": num_gaussians,
        "start": float(start),
        "dtype": dtype,
        "edge_full": bool(edge_full),
        "fuse_block": bool(fuse_block),
        "moe": normalize_moe_cfg(moe),
        "smearing": GaussianSmearing(start=start, stop=cutoff,
                                     num_gaussians=num_gaussians, type_="exp"),
    }


def compute_dtype(static: dict) -> torch.dtype:
    return _DTYPES[static.get("dtype", "float32")]


# -- initialisation (the JAX package's trees; models/nn.py's rule) ---------------

def init_node_block(gen, node_dim, edge_dim, hidden_dim, device, use_gate=True, moe=None):
    """denoiser.py:51-72: ``node_net`` is an expert bank under ``moe``."""
    if moe:
        node_net = init_moe_mlp(gen, node_dim, hidden_dim, hidden_dim, moe["num_experts"],
                                device=device)
    else:
        node_net = init_mlp(gen, node_dim, hidden_dim, hidden_dim, device=device)
    p = {
        "node_net": node_net,
        "edge_net": init_mlp(gen, edge_dim, hidden_dim, hidden_dim, device=device),
        "msg_net": init_linear(gen, hidden_dim, hidden_dim, device=device),
        "centroid_lin": init_linear(gen, node_dim, hidden_dim, device=device),
        "ln": init_layernorm(hidden_dim, device),
        "out": init_linear(gen, hidden_dim, node_dim, device=device),
    }
    if use_gate:
        p["gate"] = init_mlp(gen, edge_dim + node_dim + 1, hidden_dim, hidden_dim, device=device)
    return p


def init_bond_ffn(gen, bond_dim, node_dim, inter_dim, device, use_gate=True, out_dim=None):
    """denoiser.py:150-160."""
    out_dim = bond_dim if out_dim is None else out_dim
    p = {
        "bond_linear": init_linear(gen, bond_dim, inter_dim, bias=False, device=device),
        "node_linear": init_linear(gen, node_dim, inter_dim, bias=False, device=device),
        "inter": init_mlp(gen, inter_dim, out_dim, inter_dim, device=device),
    }
    if use_gate:
        p["gate"] = init_mlp(gen, bond_dim + node_dim + 1, out_dim, 32, device=device)
    return p


def init_edge_block(gen, edge_dim, node_dim, device, use_gate=True):
    """denoiser.py:198-210."""
    inter_dim = edge_dim * 2
    return {
        "bond_ffn_left": init_bond_ffn(gen, edge_dim, node_dim, inter_dim, device, use_gate),
        "bond_ffn_right": init_bond_ffn(gen, edge_dim, node_dim, inter_dim, device, use_gate),
        "node_ffn_left": init_linear(gen, node_dim, edge_dim, device=device),
        "node_ffn_right": init_linear(gen, node_dim, edge_dim, device=device),
        "self_ffn": init_linear(gen, edge_dim, edge_dim, device=device),
        "ln": init_layernorm(edge_dim, device),
        "out": init_linear(gen, edge_dim, edge_dim, device=device),
    }


def init_pos_update(gen, node_dim, edge_dim, hidden_dim, device, use_gate=True):
    """denoiser.py:326-335."""
    return {
        "left_lin_edge": init_mlp(gen, node_dim, edge_dim, hidden_dim, device=device),
        "right_lin_edge": init_mlp(gen, node_dim, edge_dim, hidden_dim, device=device),
        "edge_lin": init_bond_ffn(gen, edge_dim, edge_dim, node_dim, device, use_gate, out_dim=1),
    }


def init_node_edge_net(gen: torch.Generator, node_dim: int, edge_dim: int,
                       device: "str | torch.device", **denoiser_cfg):
    """(params, static config) with the blocks stacked on a leading
    ``num_blocks`` axis (denoiser.py:434-462): ``edge_emb`` reads
    [edge features || smeared distances] (the distances alone without
    ``update_edge``), ``edge_block`` exists with ``update_edge`` and
    ``pos_block`` with ``update_pos``; ``gate`` leaves with ``use_gate``."""
    static = denoiser_static_config(**denoiser_cfg)
    update_edge, update_pos = static["update_edge"], static["update_pos"]
    use_gate, num_gaussians = static["use_gate"], static["num_gaussians"]
    input_edge_dim = edge_dim + num_gaussians if update_edge else num_gaussians
    blocks = []
    for _ in range(static["num_blocks"]):
        blk = {"node_block": init_node_block(gen, node_dim, edge_dim, node_dim, device, use_gate,
                                             static["moe"]),
               "edge_emb": init_linear(gen, input_edge_dim, edge_dim, device=device)}
        if update_edge:
            blk["edge_block"] = init_edge_block(gen, edge_dim, node_dim, device, use_gate)
        if update_pos:
            blk["pos_block"] = init_pos_update(gen, node_dim, edge_dim, edge_dim, device,
                                               use_gate)
        blocks.append(blk)
    return {"blocks": tree_map(lambda *leaves: torch.stack(leaves), *blocks)}, static


def _sum_pairs(msg: torch.Tensor, pair_mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Masked messages summed over a pair axis in float32, in msg's dtype."""
    msg = msg * pair_mask.to(msg.dtype)[..., None]
    return torch.sum(msg, dim=dim, dtype=torch.float32).to(msg.dtype)


def node_block(p, x, edge_attr, node_time, pair_mask, node_mask=None, moe_cfg=None):
    """NodeBlock (denoiser.py:65-145) -> its output, and the expert bank's
    load-balance loss under ``moe_cfg`` (then ``node_mask`` is needed).
    Gated and dense: the kernel message sum (differentiable through the
    backward kernel). Otherwise JAX's plain path (:func:`_node_aggr`) on the
    routed bank's or the node MLP's output. Then centroid linear, LN, relu,
    out."""
    if moe_cfg is not None:
        h_node, moe_aux = moe_mlp(p["node_net"], x, node_mask, moe_cfg)
        aggr = _node_aggr(p, x, edge_attr, node_time, pair_mask, h_node=h_node)
        return _node_out(p, x, aggr), moe_aux
    if "gate" in p:
        aggr = kernels.node_block_aggregate_ad(
            {k: p[k] for k in ("node_net", "edge_net", "msg_net", "gate")},
            x, edge_attr, node_time, pair_mask)
        return _node_out(p, x, aggr)
    return _node_block_rows(p, _WHOLE, x, edge_attr, node_time, pair_mask, x.shape[1])


def edge_block(p, h_bond, h_node, bond_time, pair_mask, edge_full: bool = False):
    """EdgeBlock (denoiser.py:219-290). Gated: with ``edge_full`` the whole
    block is one kernel, forward and backward (rows 6, 7); otherwise the
    partial path: the kernel pair aggregate (differentiable through its
    backward kernel), then :func:`_edge_out`. Ungated: JAX's plain route
    (:func:`_edge_block_rows`)."""
    if "gate" not in p["bond_ffn_left"]:
        return _edge_block_rows(p, _WHOLE, h_bond, h_node, bond_time, pair_mask,
                                h_node.shape[1])
    if edge_full:
        return kernels.edge_block_full_ad(p, h_bond, h_node, bond_time, pair_mask)
    t_pn, u_pn = kernels.edge_pair_aggregate_ad(
        {"left": p["bond_ffn_left"], "right": p["bond_ffn_right"]},
        h_bond, h_node, bond_time, pair_mask)
    return _edge_out(p, h_bond, h_node[:, :, None, :], h_node[:, None, :, :], t_pn, u_pn)


def pos_update(p, h_node, h_edge, rel_vec, distance, edge_time, pair_mask):
    """PosUpdate (denoiser.py:338-372) -> the float32 position delta.
    Gated: the kernel alone (pallas_bwd path), differentiable through its
    backward kernel. Ungated: JAX's plain route (:func:`_pos_update_rows`),
    the force in float32."""
    if "gate" in p["edge_lin"]:
        return kernels.pos_update_ad(p, h_node, h_edge, rel_vec, distance, edge_time, pair_mask)
    return _pos_update_rows(p, _WHOLE, h_node, h_edge, rel_vec, distance, edge_time, pair_mask,
                            h_node.shape[1])


def dist_features(pos_node, static, dtype, rows=None):
    """(smeared distances in ``dtype``, rel vectors, distances) of the
    receivers ``rows`` (all of ``pos_node`` by default) against every
    sender (denoiser.py:465-478)."""
    rows = pos_node if rows is None else rows
    rel = rows[:, :, None, :] - pos_node[:, None, :, :]
    dist = safe_distance(rel)
    return static["smearing"](dist).to(dtype), rel, dist


def block_body(blk, static, h_node, h_edge, h_dist, rel_vec, distance, node_time, edge_time,
               pair_mask, node_mask=None):
    """Edge embed -> NodeBlock -> EdgeBlock -> PosUpdate on given distance
    features, without the whole-block kernel -> (h_node, h_edge, the
    position delta or None, the block's load-balance loss or None)."""
    if static["update_edge"]:
        h_edge_i = linear_parts(blk["edge_emb"], (h_edge, h_dist),
                                (h_edge.shape[-1], h_dist.shape[-1]))
    else:
        h_edge_i = linear(blk["edge_emb"], h_dist)
    moe_cfg = static.get("moe")
    h_node_delta = node_block(blk["node_block"], h_node, h_edge_i, node_time, pair_mask,
                              node_mask=node_mask, moe_cfg=moe_cfg)
    moe_aux = None
    if moe_cfg is not None:
        h_node_delta, moe_aux = h_node_delta
    if static["update_edge"]:
        h_edge_i = h_edge_i + edge_block(blk["edge_block"], h_edge_i, h_node, edge_time,
                                         pair_mask, edge_full=static["edge_full"])
    h_node = h_node + h_node_delta
    pos_delta = None
    if static["update_pos"]:
        pos_delta = pos_update(blk["pos_block"], h_node, h_edge_i, rel_vec, distance,
                               edge_time, pair_mask)
    return h_node, h_edge_i, pos_delta, moe_aux


_PARTIAL = {"update_edge": True, "update_pos": True, "edge_full": False}


def fused_block_recompute(blk, h_node, h_edge, h_dist, rel_vec, distance, node_time, pair_mask):
    """What the whole-block kernel computes, by the partial path with the
    node time as both times: the gradient of the whole block
    (pallas_kernels.py:_fb_bwd differentiates _xla_fused_block)."""
    return block_body(blk, _PARTIAL, h_node, h_edge, h_dist, rel_vec, distance, node_time,
                      node_time, pair_mask)[:3]


def apply_block(blk, static, h_node, pos_node, h_edge, node_time, edge_time, pair_mask,
                dist0=None, node_mask=None):
    """One block: edge embed -> NodeBlock -> EdgeBlock -> PosUpdate, all
    residual (denoiser.py:481-597) -> (h_node, pos_node, h_edge, the
    block's load-balance loss or None). Inputs are in the compute dtype.
    With ``fuse_block`` a gated dense block that updates edges and
    positions is the whole-block kernel (denoiser.py:521-535)."""
    update_edge, update_pos = static["update_edge"], static["update_pos"]
    if update_pos or dist0 is None:
        h_dist, rel_vec, distance = dist_features(pos_node, static, h_edge.dtype)
    else:
        h_dist, rel_vec, distance = dist0
    if (static["fuse_block"] and update_edge and update_pos and static["use_gate"]
            and static["moe"] is None):
        h_node, h_edge_i, pos_delta = kernels.fused_block_ad(
            blk, fused_block_recompute, h_node, h_edge, h_dist, rel_vec, distance, node_time,
            pair_mask)
        return h_node, pos_node + pos_delta, h_edge_i, None
    h_node, h_edge_i, pos_delta, moe_aux = block_body(
        blk, static, h_node, h_edge, h_dist, rel_vec, distance, node_time, edge_time,
        pair_mask, node_mask)
    if pos_delta is not None:
        pos_node = pos_node + pos_delta
    return h_node, pos_node, h_edge_i, moe_aux


def prepare_blocks(params: dict, static: dict) -> list:
    """Stacked block params (leading ``num_blocks`` axis, float32) -> a list
    of per-block trees in the compute dtype. The JAX forward casts every
    float32 leaf to the compute dtype first (denoiser.py:631-635); this does
    the same once, so a sampler can reuse the result at every step."""
    dt = compute_dtype(static)
    cast = tree_map(lambda x: x.to(dt) if x.dtype == torch.float32 else x, params["blocks"])
    return [tree_map(lambda x, k=k: x[k], cast) for k in range(static["num_blocks"])]


def node_edge_net(params, static, h_node, pos_node, h_edge, node_time, edge_time,
                  pair_mask, blocks: Optional[list] = None, node_mask=None,
                  pair_sharding=None):
    """Forward pass -> (h_node, pos_node, h_edge), and with ``moe`` also the
    load-balance loss, the mean over blocks (denoiser.py:600-666);
    ``node_mask`` [B, N] is needed under ``moe``.

    ``blocks``: the output of :func:`prepare_blocks` for ``params``; made
    here when not given. A Python loop over blocks replaces ``lax.scan``.
    ``pair_sharding`` (parallel/collectives.py PairSharding): JAX's plain
    route, row-split over the graph axis (:func:`node_edge_net_sharded`).
    """
    if pair_sharding is not None:
        return node_edge_net_sharded(params, static, h_node, pos_node, h_edge, node_time,
                                     edge_time, pair_mask, pair_sharding, node_mask=node_mask)
    dt = compute_dtype(static)
    in_dtype = h_node.dtype
    if blocks is None:
        blocks = prepare_blocks(params, static)
    h_node = h_node.to(dt)
    h_edge = h_edge.to(dt)
    dist0 = None if static["update_pos"] else dist_features(pos_node, static, dt)
    auxes = []
    for blk in blocks:
        h_node, pos_node, h_edge, moe_aux = apply_block(
            blk, static, h_node, pos_node, h_edge, node_time, edge_time, pair_mask,
            dist0=dist0, node_mask=node_mask)
        auxes.append(moe_aux)
    out = (h_node.to(in_dtype), pos_node, h_edge.to(in_dtype))
    if static["moe"] is not None:
        return out + (torch.stack(auxes).mean(),)
    return out


# -- JAX's plain route, row-split over the graph axis ------------------------------

# one rank holding every row, no model split: every collective is the
# identity (the ungated blocks off a graph axis take the route so)
_WHOLE = collectives.PairSharding(collectives.Axis("graph"), collectives.Axis("model"))


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended on axis 1 up to ``rows``."""
    extra = rows - x.shape[1]
    return x if extra == 0 else F.pad(x, [0, 0] * (x.dim() - 2) + [0, extra])


def _own_rows(ps, x: torch.Tensor, n_loc: int) -> torch.Tensor:
    """This graph rank's rows of axis 1 of ``x`` (padded), no collective:
    for a tensor that passed ``copy_to``."""
    return _pad_rows(x, n_loc * ps.graph.size).narrow(1, ps.graph.rank * n_loc, n_loc)


def bond_ffn(p, bond_feat, node_feat, time, tp=None):
    """BondFFN, JAX's plain math (denoiser.py:163-195): the bond and node
    linears' product through the inter MLP, gated (where ``gate`` is in
    ``p``) by the gate MLP over [bond || node || time]. ``tp``: the model
    axis of split MLPs."""
    while time.dim() < bond_feat.dim():
        time = time[..., None]
    inter = linear(p["bond_linear"], bond_feat) * linear(p["node_linear"], node_feat)
    inter = mlp(p["inter"], inter, tp)
    if "gate" in p:
        gate = mlp_parts(p["gate"], (bond_feat, node_feat, time.to(bond_feat.dtype)),
                         (bond_feat.shape[-1], node_feat.shape[-1], 1), tp)
        inter = inter * torch.sigmoid(gate)
    return inter


def _node_aggr(p, x, edge_attr, node_time, pair_mask, tp=None, h_node=None):
    """NodeBlock's plain message sum (denoiser.py:114-142) over the senders
    of ``x`` [B, N, Dn] into the receivers of ``edge_attr`` and
    ``pair_mask``: the node MLP (or ``h_node``, the routed bank's output),
    the edge MLP, the message linear, the gate MLP over [edge || node of the
    sender || time] where gated, summed in float32. ``tp``: the model axis
    of split MLPs."""
    if h_node is None:
        h_node = mlp(p["node_net"], x, tp)
    msg = linear(p["msg_net"], mlp(p["edge_net"], edge_attr, tp) * h_node[:, None, :, :])
    if "gate" in p:
        gate = mlp_parts(p["gate"], (edge_attr, x[:, None, :, :],
                                     node_time.to(x.dtype)[..., None]),
                         (edge_attr.shape[-1], x.shape[-1], 1), tp)
        msg = msg * torch.sigmoid(gate)
    return _sum_pairs(msg, pair_mask, 2)


def _node_out(p, x_rows, aggr):
    """NodeBlock's tail: the centroid linear of the receivers ``x_rows``
    plus the message sum, LN, relu, out."""
    out = linear(p["centroid_lin"], x_rows) + aggr
    out = layernorm(p["ln"], out)
    return linear(p["out"], torch.relu(out))


def _node_block_rows(p, ps, x, edge_attr, node_time, pair_mask, n_loc: int, node_mask=None,
                     moe_cfg=None):
    """NodeBlock's plain route for this rank's rows: ``x`` [B, N, Dn]
    (passed ``copy_to``), ``edge_attr`` and ``pair_mask`` the rank's rows
    -> its rows of the update, and under ``moe_cfg`` the expert bank's
    load-balance loss. The bank runs on every node (replicated over graph,
    its capacity from the real N), its experts' MLPs split over model."""
    h_node = moe_aux = None
    if moe_cfg is not None:
        h_node, moe_aux = moe_mlp(p["node_net"], x, node_mask, moe_cfg, tp=ps.model)
    aggr = _node_aggr(p, x, edge_attr, node_time, pair_mask, ps.model, h_node=h_node)
    out = _node_out(p, _own_rows(ps, x, n_loc), aggr)
    return out if moe_cfg is None else (out, moe_aux)


def _edge_block_rows(p, ps, h_bond, x, bond_time, pair_mask, n_loc: int):
    """EdgeBlock's plain route (denoiser.py:263-283) for this rank's rows:
    T (the sum over receivers) reduce-scattered to the rank's rows, U (the
    sum over senders) all-gathered for every column."""
    graph, tp = ps.graph, ps.model
    n, dt = x.shape[1], h_bond.dtype
    mask = pair_mask.to(dt)[..., None]
    h_left = _own_rows(ps, x, n_loc)[:, :, None, :]
    h_right = x[:, None, :, :]
    msg_left = bond_ffn(p["bond_ffn_left"], h_bond, h_left, bond_time, tp) * mask
    t_part = torch.sum(msg_left, dim=1, dtype=torch.float32)
    t_rows = collectives.reduce_scatter(graph, _pad_rows(t_part, n_loc * graph.size), 1).to(dt)
    msg_right = bond_ffn(p["bond_ffn_right"], h_bond, h_right, bond_time, tp) * mask
    u_rows = torch.sum(msg_right, dim=2, dtype=torch.float32).to(dt)
    u = collectives.gather_shared(graph, u_rows, 1)[:, :n]
    return _edge_out(p, h_bond, h_left, h_right, t_rows, u)


def _edge_out(p, h_bond, h_left, h_right, t, u):
    """EdgeBlock's tail (denoiser.py:278-290): the pair sums T (by
    receiver) and U (by sender), the node and self FFNs, LN, relu, out."""
    h = (t[:, :, None, :] + u[:, None, :, :]
         + linear(p["node_ffn_left"], h_left)
         + linear(p["node_ffn_right"], h_right)
         + linear(p["self_ffn"], h_bond))
    h = layernorm(p["ln"], h)
    return linear(p["out"], torch.relu(h))


def _pos_update_rows(p, ps, x, h_edge, rel_vec, distance, edge_time, pair_mask, n_loc: int):
    """PosUpdate's plain route (denoiser.py:352-375) for this rank's rows
    -> its rows of the float32 position delta."""
    tp = ps.model
    left = mlp(p["left_lin_edge"], _own_rows(ps, x, n_loc), tp)[:, :, None, :]
    right = mlp(p["right_lin_edge"], x, tp)[:, None, :, :]
    weight = bond_ffn(p["edge_lin"], h_edge, left * right, edge_time, tp)
    mask = pair_mask[..., None]
    d = distance[..., None]
    d_safe = torch.where(mask > 0, d, torch.ones_like(d))
    force = weight.to(torch.float32) * rel_vec / d_safe / (d_safe + 1.0)
    return torch.sum(force * mask.to(torch.float32), dim=2)


def _block_rows(blk, static, ps, h_node, pos_node, h_edge, node_time, edge_time, pair_mask,
                n_loc: int, dist0=None, node_mask=None) -> tuple:
    """One block (denoiser.py:481-597) on this rank's rows of the edge
    features -> (h_node, pos_node: replicated; h_edge: the rank's rows;
    the block's load-balance loss or None)."""
    graph = ps.graph
    n = h_node.shape[1]
    if static["update_pos"] or dist0 is None:
        x, pos = collectives.copy_to(graph, h_node, pos_node)
        h_dist, rel_vec, distance = dist_features(pos, static, h_edge.dtype,
                                                  _own_rows(ps, pos, n_loc))
    else:
        x = collectives.copy_to(graph, h_node)
        h_dist, rel_vec, distance = dist0
    if static["update_edge"]:
        h_edge_i = linear_parts(blk["edge_emb"], (h_edge, h_dist),
                                (h_edge.shape[-1], h_dist.shape[-1]))
    else:
        h_edge_i = linear(blk["edge_emb"], h_dist)
    moe_cfg = static.get("moe")
    delta = _node_block_rows(blk["node_block"], ps, x, h_edge_i, node_time, pair_mask, n_loc,
                             node_mask, moe_cfg)
    moe_aux = None
    if moe_cfg is not None:
        delta, moe_aux = delta
    delta = collectives.gather(graph, delta, 1)[:, :n]
    if static["update_edge"]:
        h_edge_i = h_edge_i + _edge_block_rows(blk["edge_block"], ps, h_edge_i, x, edge_time,
                                               pair_mask, n_loc)
    h_node = h_node + delta
    if static["update_pos"]:
        x = collectives.copy_to(graph, h_node)
        d_pos = _pos_update_rows(blk["pos_block"], ps, x, h_edge_i, rel_vec, distance,
                                 edge_time, pair_mask, n_loc)
        pos_node = pos_node + collectives.gather(graph, d_pos, 1)[:, :n]
    return h_node, pos_node, h_edge_i, moe_aux


def node_edge_net_sharded(params, static, h_node, pos_node, h_edge, node_time, edge_time,
                          pair_mask, pair_sharding, node_mask=None):
    """:func:`node_edge_net` by JAX's plain route with the pair tensors'
    receiver axis split over the graph axis of ``pair_sharding`` (and the
    split MLPs over its model axis), as the module docstring sets out ->
    (h_node, pos_node, h_edge), all replicated, and under ``moe`` the
    blocks' mean load-balance loss. Every rank of the graph and model axes
    passes the same (replicated) inputs and its shards of ``params``.

    The loss is replicated work whose gradient every graph rank would
    carry whole into the ``copy_to`` all-reduces of the router and the
    node features: it passes ``collectives.once``, so the graph sums count
    it once."""
    ps, graph = pair_sharding, pair_sharding.graph
    dt, in_dtype = compute_dtype(static), h_node.dtype
    n = h_node.shape[1]
    n_loc = -(-n // graph.size)
    like = params["blocks"]
    leaves = collectives.copy_to(graph, *tree_leaves(like))
    leaves = list(leaves) if isinstance(leaves, tuple) else [leaves]
    blocks = prepare_blocks({"blocks": tree_unflatten(like, leaves)}, static)
    h_node = h_node.to(dt)
    pm_rows = _own_rows(ps, pair_mask, n_loc)
    h_edge = collectives.scatter(graph, _pad_rows(h_edge.to(dt), n_loc * graph.size), 1)
    dist0 = None
    if not static["update_pos"]:
        pos = collectives.copy_to(graph, pos_node)
        dist0 = dist_features(pos, static, dt, _own_rows(ps, pos, n_loc))
    auxes = []
    for blk in blocks:
        h_node, pos_node, h_edge, moe_aux = _block_rows(
            blk, static, ps, h_node, pos_node, h_edge, node_time, edge_time, pm_rows, n_loc,
            dist0, node_mask)
        auxes.append(moe_aux)
    h_edge = collectives.gather(graph, h_edge, 1)[:, :n]
    out = (h_node.to(in_dtype), pos_node, h_edge.to(in_dtype))
    if static.get("moe") is not None:
        return out + (collectives.once(graph, torch.stack(auxes).mean()),)
    return out
