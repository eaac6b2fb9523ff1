"""Bond predictor: p(bond type | noisy atom types + positions), the
classifier whose gradient with respect to positions guides sampling
(moldiff_tpu/models/bond_predictor.py:27-170).

It runs the NodeEdgeNet encoder of models/denoiser.py with
``update_pos: false`` (distances computed once), so its gradient goes
through the NodeBlock and EdgeBlock pair kernels, forward and backward.
Sampling builds it with ``num_edge_types = num_bond_types + 1``: no mask
class (scripts/sample_drug3d.py:191-197).

Training (bond_predictor.py:67-87, :172-219): :meth:`init_params` and the
loss :meth:`get_loss`, a weighted cross-entropy on the clean bond labels
given noised positions and atom types. Its random numbers (the antithetic
time draw and the two forward noisings) come in as :class:`BondLossNoise`,
so one loss can be checked against the JAX package's given the same noise.
An encoder with ``moe`` adds ``loss_moe`` (aux_weight x the load-balance
loss) to the loss (:210-218); an ungated one runs JAX's plain blocks
(models/denoiser.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import graph_ops
from ..ops.categorical import CategoricalTransition
from ..ops.gaussian import GaussianTransition
from ..ops.schedules import get_beta_schedule
from .denoiser import denoiser_static_config, init_node_edge_net, node_edge_net, prepare_blocks
from .moldiff import masked_mean, resolve_device, sample_time_antithetic
from .nn import GaussianSmearing, init_linear, init_mlp, linear, linear_parts, mlp


class BondLossNoise(NamedTuple):
    """The random numbers of one predictor loss (all None without time)."""
    t: Optional[torch.Tensor]      # [B] int timesteps (sample_time_antithetic)
    pos: Optional[torch.Tensor]    # [B, N, 3] standard normal
    node: Optional[torch.Tensor]   # [B, N, Kn] uniform [0, 1)


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
        self._encoder_cfg = encoder_cfg
        self.encoder_static = denoiser_static_config(**encoder_cfg)
        # cross-entropy class weights, "no bond" down-weighted (:60-62)
        self.edge_weight = torch.tensor([0.1] + [1.0] * (num_edge_types - 1),
                                        dtype=torch.float32, device=self.device)
        # set by the trainer on a mesh with a graph axis: MolDiff.pair_sharding
        # (bond_predictor.py:65)
        self.pair_sharding = None

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh float32 params on the predictor's device from ``generator``
        (bond_predictor.py:67-87): the embedders without bias, the encoder
        and a 3-layer edge decoder."""
        dev = self.device
        encoder, _ = init_node_edge_net(generator, self.node_dim, self.edge_dim, dev,
                                        **self._encoder_cfg)
        return {
            "node_embedder": init_linear(generator, self.num_node_types,
                                         self.node_dim - self.time_dim, bias=False, device=dev),
            "edge_embedder": init_linear(generator, self.num_node_types * 2,
                                         self.edge_dim - self.time_dim, bias=False, device=dev),
            "encoder": encoder,
            "edge_decoder": init_mlp(generator, self.edge_dim + self.node_dim,
                                     self.num_edge_types, self.edge_dim, num_layer=3,
                                     device=dev),
        }

    def prepare(self, params: dict) -> list:
        """Per-block encoder params in the compute dtype, made once per
        sampling run and passed to :meth:`forward`."""
        return prepare_blocks(params["encoder"], self.encoder_static)

    def forward(self, params: dict, h_node: torch.Tensor, pos_node: torch.Tensor,
                t: Optional[torch.Tensor], node_mask: torch.Tensor,
                blocks: Optional[list] = None, return_moe_aux: bool = False):
        """Bond-type logits per half-edge [B, E, Ke] (bond_predictor.py:89-170).
        h_node [B,N,Kn] atom types, pos_node [B,N,3], t [B] int (None when
        the predictor has no time), node_mask [B,N]. ``return_moe_aux``:
        (logits, the MoE load-balance scalar or None)."""
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
        out = node_edge_net(params["encoder"], self.encoder_static, h_node_emb, pos_node,
                            h_edge_emb, node_time=t_norm, edge_time=t_norm, pair_mask=pair_mask,
                            blocks=blocks, node_mask=node_mask, pair_sharding=self.pair_sharding)
        h_node_out, _, h_edge_out = out[:3]
        dev = str(h_node.device)
        iu = graph_ops._index_tensor("iu", n, dev)
        ju = graph_ops._index_tensor("ju", n, dev)
        h_half_sym = graph_ops.dense_to_halfedge(graph_ops.symmetrize_dense(h_edge_out))
        h_node_pair = h_node_out[:, iu] + h_node_out[:, ju]
        tp = self.pair_sharding.model if self.pair_sharding is not None else None
        pred = mlp(params["edge_decoder"], torch.cat([h_half_sym, h_node_pair], dim=-1), tp)
        if return_moe_aux:
            return pred, (out[3] if len(out) > 3 else None)
        return pred

    # -- training loss ---------------------------------------------------------

    def draw_loss_noise(self, b: int, n: int, generator: torch.Generator) -> BondLossNoise:
        """Fresh noise for one :meth:`get_loss` on a [B, N] batch, drawn in
        the order of JAX's ``split(key, 3)``: time, positions, atom types."""
        if self.num_timesteps == 0:
            return BondLossNoise(None, None, None)
        dev = self.device
        half = torch.randint(0, self.num_timesteps, (b // 2 + 1,), generator=generator,
                             device=dev)
        return BondLossNoise(
            t=sample_time_antithetic(half, b, self.num_timesteps),
            pos=torch.randn((b, n, 3), generator=generator, device=dev),
            node=torch.rand((b, n, self.num_node_types), generator=generator, device=dev))

    def loss_counts(self, node_type, halfedge_type, node_mask) -> dict:
        """The denominators of :meth:`get_loss` on this batch (the summed
        class weights of the real targets, the real bonded half-edges),
        which a data-parallel step sums over the ranks before the forward
        pass."""
        halfedge_mask = graph_ops.halfedge_mask_from_node_mask(node_mask)
        labels = halfedge_type.long()
        return {"weight": torch.sum(self.edge_weight[labels] * halfedge_mask),
                "bond": torch.sum(halfedge_mask * (labels > 0))}

    def get_loss(self, params: dict, node_type, node_pos, halfedge_type, node_mask,
                 noise: BondLossNoise, counts: Optional[dict] = None):
        """Weighted cross-entropy on the half-edge logits (bond_predictor.py:
        172-219): positions and atom types noised at the drawn time, bond
        labels clean; normalised by the summed weights of the real targets,
        as torch's CrossEntropyLoss(weight=w). ``acc_bond`` is the accuracy
        over real bonded half-edges; with ``moe`` the loss adds ``loss_moe``.
        node_type [B,N] int, node_pos [B,N,3], halfedge_type [B,E] int,
        node_mask [B,N] -> (loss, dict of terms).
        ``counts``: :meth:`loss_counts` summed over the ranks that split the
        batch."""
        c = counts or {}
        halfedge_mask = graph_ops.halfedge_mask_from_node_mask(node_mask)
        if self.num_timesteps > 0:
            t = noise.t
            pos = self.pos_transition.add_noise(node_pos, t, noise.pos)
            h_node, _, _ = self.node_transition.add_noise(node_type, t, noise.node)
        else:
            t, pos = None, node_pos
            h_node = torch.nn.functional.one_hot(node_type.long(), self.num_node_types).float()
        pred, moe_aux = self.forward(params, h_node, pos, t, node_mask, return_moe_aux=True)
        log_prob = torch.log_softmax(pred, dim=-1)
        labels = halfedge_type.long()
        nll = -torch.gather(log_prob, -1, labels[..., None])[..., 0]
        w = self.edge_weight[labels] * halfedge_mask
        weight = torch.sum(w) if c.get("weight") is None else c["weight"]
        loss = torch.sum(nll * w) / torch.clamp(weight, min=1e-8)
        acc = masked_mean((torch.argmax(pred, dim=-1) == labels).float(),
                          halfedge_mask * (labels > 0), c.get("bond"))
        aux = {"loss": loss, "loss_edge": loss, "acc_bond": acc}
        if moe_aux is not None:
            aux["loss_moe"] = self.encoder_static["moe"]["aux_weight"] * moe_aux
            loss = aux["loss"] = loss + aux["loss_moe"]
        return loss, aux
