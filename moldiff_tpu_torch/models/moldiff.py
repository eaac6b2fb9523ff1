"""MolDiff forward and the unguided reverse sampler (moldiff_tpu/models/moldiff.py).

Positions [B, N, 3] follow a Gaussian diffusion; atom types [B, N, Kn] and
bond types on half-edges [B, E, Ke] follow categorical diffusions with the
``tomask`` and ``absorb`` priors. A Python loop over the T steps replaces
the JAX package's ``lax.scan``. Every random draw of a step comes in as
:class:`StepNoise`, made from an explicit ``torch.Generator``: the step
function itself is deterministic, so one step can be checked against the
JAX package given the same noise.

Ported: ``forward`` (:178-249), ``sample`` (:425) with ``ddpm`` positions
and ``commit`` in {"none", "nodes"}, and its step (:559). Not yet: guidance,
respacing, DDIM, edge commit, the continuous categorical mode, the loss.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import graph_ops
from ..ops.categorical import CategoricalTransition, index_to_log_onehot, log_sample_categorical
from ..ops.gaussian import GaussianTransition
from ..ops.schedules import get_beta_schedule
from .denoiser import denoiser_static_config, node_edge_net, prepare_blocks
from .nn import GaussianSmearing, linear, mlp

COMMIT_MODES = ("none", "nodes")


class MolDiffPreds(NamedTuple):
    pred_node: torch.Tensor      # [B, N, Kn] logits of v0
    pred_pos: torch.Tensor       # [B, N, 3]  x0 prediction
    pred_halfedge: torch.Tensor  # [B, E, Ke] logits of e0


class StepNoise(NamedTuple):
    """The random numbers of one reverse step (or of the prior draw)."""
    pos: torch.Tensor    # [B, N, 3] standard normal
    node: torch.Tensor   # [B, N, Kn] uniform [0, 1)
    edge: torch.Tensor   # [B, E, Ke] uniform [0, 1)


class SampleState(NamedTuple):
    pos: torch.Tensor
    h_node: torch.Tensor
    h_halfedge: torch.Tensor
    log_node: torch.Tensor
    log_halfedge: torch.Tensor
    com_node: torch.Tensor       # [B, N] committed class, -1 = not yet
    preds: Optional[MolDiffPreds] = None


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The port's entry points run on the card unless told otherwise."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return device


class MolDiff:
    """Schedule constants and the static architecture; every compute method
    is a function of (params, inputs, noise)."""

    def __init__(self, config: dict, num_node_types: int, num_edge_types: int,
                 device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        self.num_node_types = num_node_types
        self.num_edge_types = num_edge_types
        diff = config["diff"]
        self.num_timesteps = diff["num_timesteps"]
        self.time_dim = diff["time_dim"]
        if diff.get("categorical_space", "discrete") != "discrete":
            raise NotImplementedError("the continuous categorical mode is not ported yet")
        no_init = lambda d: {k: v for k, v in d.items() if k != "init_prob"}
        T = self.num_timesteps
        self.pos_transition = GaussianTransition(
            get_beta_schedule(num_timesteps=T, **diff["diff_pos"]), device=self.device)
        self.node_transition = CategoricalTransition(
            get_beta_schedule(num_timesteps=T, **no_init(diff["diff_atom"])), num_node_types,
            init_prob=diff["diff_atom"]["init_prob"], device=self.device)
        self.edge_transition = CategoricalTransition(
            get_beta_schedule(num_timesteps=T, **no_init(diff["diff_bond"])), num_edge_types,
            init_prob=diff["diff_bond"]["init_prob"], device=self.device)
        denoiser_cfg = dict(config["denoiser"])
        denoiser_cfg.pop("backbone", None)
        self.denoiser_static = denoiser_static_config(**denoiser_cfg)
        self.time_emb = GaussianSmearing(stop=T, num_gaussians=self.time_dim, type_="linear")

    # -- denoiser forward ----------------------------------------------------

    def prepare(self, params: dict) -> list:
        """Per-block params in the compute dtype (denoiser.prepare_blocks),
        made once per sampling run and passed to :meth:`forward`."""
        return prepare_blocks(params["denoiser"], self.denoiser_static)

    def forward(self, params: dict, h_node_pert, pos_pert, h_halfedge_pert, t, node_mask,
                blocks: Optional[list] = None) -> MolDiffPreds:
        """Predict the clean (t = 0) quantities (moldiff.py:178-249).
        h_node_pert [B,N,Kn], pos_pert [B,N,3], h_halfedge_pert [B,E,Ke],
        t [B] int, node_mask [B,N]."""
        b, n = h_node_pert.shape[:2]
        pair_mask = graph_ops.pair_mask_from_node_mask(node_mask)
        t_float = t.to(torch.float32)
        time_feat = self.time_emb(t_float)
        h_node = torch.cat([linear(params["node_embedder"], h_node_pert),
                            time_feat[:, None, :].expand(b, n, self.time_dim)], dim=-1)
        h_edge_dense = graph_ops.halfedge_to_dense(h_halfedge_pert, n)
        h_edge = torch.cat([linear(params["edge_embedder"], h_edge_dense),
                            time_feat[:, None, None, :].expand(b, n, n, self.time_dim)], dim=-1)
        t_norm = (t_float / self.num_timesteps)[:, None, None]
        h_node, pos_out, h_edge = node_edge_net(
            params["denoiser"], self.denoiser_static, h_node, pos_pert, h_edge,
            node_time=t_norm, edge_time=t_norm, pair_mask=pair_mask, blocks=blocks)
        pred_node = mlp(params["node_decoder"], h_node)
        h_half_sym = graph_ops.dense_to_halfedge(graph_ops.symmetrize_dense(h_edge))
        pred_halfedge = mlp(params["edge_decoder"], h_half_sym)
        return MolDiffPreds(pred_node, pos_out, pred_halfedge)

    # -- sampling --------------------------------------------------------------

    def draw_noise(self, b: int, n: int, generator: torch.Generator) -> StepNoise:
        e = graph_ops.num_halfedges(n)
        dev = self.device
        return StepNoise(
            pos=torch.randn((b, n, 3), generator=generator, device=dev),
            node=torch.rand((b, n, self.num_node_types), generator=generator, device=dev),
            edge=torch.rand((b, e, self.num_edge_types), generator=generator, device=dev),
        )

    def init_state(self, node_mask: torch.Tensor, noise: StepNoise) -> SampleState:
        """The prior draw x_T, v_T, e_T (moldiff.py:513-517)."""
        b, n = node_mask.shape
        e = graph_ops.num_halfedges(n)
        _, h_node, log_node = self.node_transition.sample_init((b, n), noise.node)
        pos = self.pos_transition.sample_init(noise.pos)
        _, h_half, log_half = self.edge_transition.sample_init((b, e), noise.edge)
        com_node = torch.full((b, n), -1, dtype=torch.long, device=node_mask.device)
        return SampleState(pos, h_node, h_half, log_node, log_half, com_node)

    def reverse_step(self, params: dict, state: SampleState, step: int, node_mask,
                     noise: StepNoise, commit: str = "none",
                     blocks: Optional[list] = None) -> SampleState:
        """One ancestral reverse step t = step -> step - 1 (the scan body of
        moldiff.py:559-755, unguided, ddpm positions)."""
        if commit not in COMMIT_MODES:
            raise ValueError(f"commit must be one of {COMMIT_MODES}, got {commit!r}")
        node_tr, edge_tr = self.node_transition, self.edge_transition
        b = node_mask.shape[0]
        t = torch.full((b,), step, dtype=torch.long, device=node_mask.device)
        preds = self.forward(params, state.h_node, state.pos, state.h_halfedge, t, node_mask,
                             blocks=blocks)
        pos_prev = self.pos_transition.get_prev_from_recon(state.pos, preds.pred_pos, t,
                                                           noise.pos)

        log_node_recon = torch.log_softmax(preds.pred_node, dim=-1)
        com_node = state.com_node
        if commit == "nodes":
            log_node_recon = torch.where(
                (com_node >= 0)[..., None],
                index_to_log_onehot(torch.clamp(com_node, min=0), self.num_node_types),
                log_node_recon)
        log_node_new = node_tr.q_v_posterior(log_node_recon, state.log_node, t)
        node_type_prev = log_sample_categorical(log_node_new, noise.node)
        if commit == "nodes":
            # freeze a draw when the model term of the reveal jump beats the
            # prior-leak term for the drawn class (moldiff.py:623-642)
            abar_n = node_tr.alphas_bar[max(step - 1, 0)]
            p_drawn = torch.gather(torch.exp(log_node_recon), -1,
                                   node_type_prev[..., None])[..., 0]
            pi_drawn = node_tr.init_prob[node_type_prev]
            reveal = ((com_node < 0) & (node_type_prev != self.num_node_types - 1)
                      & (abar_n * p_drawn > (1.0 - abar_n) * pi_drawn))
            com_node = torch.where(reveal, node_type_prev, com_node)
            node_type_prev = torch.where(com_node >= 0, com_node, node_type_prev)

        log_edge_recon = torch.log_softmax(preds.pred_halfedge, dim=-1)
        log_half_new = edge_tr.q_v_posterior(log_edge_recon, state.log_halfedge, t)
        half_type_prev = log_sample_categorical(log_half_new, noise.edge)
        if commit == "nodes":
            # decode reads the clamped v0 views (moldiff.py:713-717)
            preds = MolDiffPreds(log_node_recon, preds.pred_pos, log_edge_recon)
        return SampleState(pos_prev, node_tr.onehot_encode(node_type_prev),
                           edge_tr.onehot_encode(half_type_prev), log_node_new, log_half_new,
                           com_node, preds)

    def sample(self, params: dict, node_mask: torch.Tensor, generator: torch.Generator,
               commit: str = "none") -> MolDiffPreds:
        """Full T-step reverse chain (moldiff.py:425-540); returns the final
        step's predictions, which decoding reads."""
        b, n = node_mask.shape
        blocks = self.prepare(params)
        state = self.init_state(node_mask, self.draw_noise(b, n, generator))
        for step in range(self.num_timesteps - 1, -1, -1):
            state = self.reverse_step(params, state, step, node_mask,
                                      self.draw_noise(b, n, generator), commit=commit,
                                      blocks=blocks)
        return state.preds
