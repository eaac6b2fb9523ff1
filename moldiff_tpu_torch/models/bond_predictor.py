"""Bond predictor: p(bond type | noisy atom types + positions), the
classifier whose gradient with respect to positions guides sampling
(moldiff_tpu/models/bond_predictor.py:27-170).

It runs the NodeEdgeNet encoder of models/denoiser.py with
``update_pos: false`` (distances computed once), so its gradient goes
through the NodeBlock and EdgeBlock pair kernels, forward and backward.
Sampling builds it with ``num_edge_types = num_bond_types + 1``: no mask
class (scripts/sample_drug3d.py:191-197). Only the forward is ported; the
loss is not.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import graph_ops
from ..ops.categorical import CategoricalTransition
from ..ops.gaussian import GaussianTransition
from ..ops.schedules import get_beta_schedule
from .denoiser import denoiser_static_config, node_edge_net, prepare_blocks
from .moldiff import resolve_device
from .nn import GaussianSmearing, linear, linear_parts, mlp


class BondPredictor:
    """Schedules, time features and static architecture; ``forward`` is a
    function of (params, inputs)."""

    def __init__(self, config: dict, num_node_types: int, num_edge_types: int,
                 device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        self.num_node_types = num_node_types
        self.num_edge_types = num_edge_types
        diff = config["diff"]
        self.num_timesteps = diff["num_timesteps"]
        if self.num_timesteps > 0:
            T = self.num_timesteps
            self.time_dim = diff["time_dim"]
            self.pos_transition = GaussianTransition(
                get_beta_schedule(num_timesteps=T, **diff["diff_pos"]), device=self.device)
            self.node_transition = CategoricalTransition(
                get_beta_schedule(num_timesteps=T, **{k: v for k, v in diff["diff_atom"].items()
                                                      if k != "init_prob"}),
                num_node_types, init_prob=diff["diff_atom"]["init_prob"], device=self.device)
            self.time_emb = GaussianSmearing(stop=T, num_gaussians=self.time_dim, type_="linear")
        else:
            self.time_dim = 0
        self.node_dim = config["node_dim"]
        self.edge_dim = config["edge_dim"]
        encoder_cfg = dict(config["encoder"])
        encoder_cfg.pop("backbone", None)
        self.encoder_static = denoiser_static_config(**encoder_cfg)

    def prepare(self, params: dict) -> list:
        """Per-block encoder params in the compute dtype, made once per
        sampling run and passed to :meth:`forward`."""
        return prepare_blocks(params["encoder"], self.encoder_static)

    def forward(self, params: dict, h_node: torch.Tensor, pos_node: torch.Tensor,
                t: Optional[torch.Tensor], node_mask: torch.Tensor,
                blocks: Optional[list] = None) -> torch.Tensor:
        """Bond-type logits per half-edge [B, E, Ke] (bond_predictor.py:89-170).
        h_node [B,N,Kn] atom types, pos_node [B,N,3], t [B] int (None when
        the predictor has no time), node_mask [B,N]."""
        b, n, kn = h_node.shape
        pair_mask = graph_ops.pair_mask_from_node_mask(node_mask)
        # edge features embed [types of i || types of j] as two O(N) products
        edge_raw = linear_parts(params["edge_embedder"],
                                (h_node[:, :, None, :], h_node[:, None, :, :]), (kn, kn))
        if self.num_timesteps > 0:
            t_float = t.to(torch.float32)
            time_feat = self.time_emb(t_float)
            h_node_emb = torch.cat([linear(params["node_embedder"], h_node),
                                    time_feat[:, None, :].expand(b, n, self.time_dim)], dim=-1)
            h_edge_emb = torch.cat([edge_raw, time_feat[:, None, None, :].expand(
                b, n, n, self.time_dim)], dim=-1)
            t_norm = (t_float / max(self.num_timesteps, 1))[:, None, None]
        else:
            h_node_emb = linear(params["node_embedder"], h_node)
            h_edge_emb = edge_raw
            t_norm = torch.zeros((b, 1, 1), dtype=torch.float32, device=h_node.device)
        h_node_out, _, h_edge_out = node_edge_net(
            params["encoder"], self.encoder_static, h_node_emb, pos_node, h_edge_emb,
            node_time=t_norm, edge_time=t_norm, pair_mask=pair_mask, blocks=blocks)
        dev = str(h_node.device)
        iu = graph_ops._index_tensor("iu", n, dev)
        ju = graph_ops._index_tensor("ju", n, dev)
        h_half_sym = graph_ops.dense_to_halfedge(graph_ops.symmetrize_dense(h_edge_out))
        h_node_pair = h_node_out[:, iu] + h_node_out[:, ju]
        return mlp(params["edge_decoder"], torch.cat([h_half_sym, h_node_pair], dim=-1))
