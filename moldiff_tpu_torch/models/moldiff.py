"""MolDiff forward and the reverse sampler, with bond guidance
(moldiff_tpu/models/moldiff.py).

Positions [B, N, 3] follow a Gaussian diffusion; atom types [B, N, Kn] and
bond types on half-edges [B, E, Ke] follow categorical diffusions with the
``tomask`` and ``absorb`` priors. A Python loop over the T steps replaces
the JAX package's ``lax.scan``. Every random draw of a step comes in as
:class:`StepNoise`, made from an explicit ``torch.Generator``: the step
function itself is deterministic, so one step can be checked against the
JAX package given the same noise.

Ported: ``init_params`` (:159-176), ``forward`` (:178-249), ``sample``
(:425) and its step (:559) in every discrete mode: full or respaced chains (``_respaced``, :375: the
posterior math on the respaced transitions, the denoiser and the bond
predictor on the original timestep), ``ddpm`` or ``ddim`` positions,
``commit`` in {"none", "nodes", "edges", "both"} and trajectories; the bond
predictor's position guidance in all eight modes (:960-1044) and its
class-space edge guidance (:650-675); the training loss ``get_loss``
(:253-373), its noise (the time draw and the three forward noisings) passed
in as :class:`LossNoise`, with the MoE load-balance term ``loss_moe``
(:358-368). ``sample_chunked`` (:755) is not ported: it exists for TPU
execution deadlines.

The continuous categorical space (``diff.categorical_space: continuous``,
:101-137): atom and bond types diffuse as Gaussians on one-hots divided by
``diff.scaling[1:]``; the loss is the MSE to them x 30 (:347-356) and the
reverse step (:878-968, :meth:`reverse_step` on such a model) draws all
three chains from their Gaussian posteriors, position guidance included
(bond inputs: the argmax and log-softmax of the new bond features). As in
JAX it reads neither ``commit`` nor ``pos_sampler`` (nor ``eta`` and
``guidance_interval``: guidance runs every step). One departure: JAX
ignores ``edge_guidance > 0`` in this space; the port raises ValueError.

Sampling runs under ``torch.no_grad()``; the guidance delta re-enables
autograd for the predictor's forward and its gradient with respect to the
positions (the reference's model.py:309-362 does the same), which runs
through the backward pair kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import graph_ops
from ..ops.categorical import CategoricalTransition, index_to_log_onehot, log_sample_categorical
from ..ops.gaussian import GaussianTransition
from ..ops.respace import respace_timesteps, respaced_betas
from ..ops.schedules import get_beta_schedule
from .denoiser import denoiser_static_config, init_node_edge_net, node_edge_net, prepare_blocks
from .nn import GaussianSmearing, init_linear, init_mlp, linear, mlp, safe_distance

COMMIT_MODES = ("none", "nodes", "edges", "both")
POS_SAMPLERS = ("ddpm", "ddim")

# drift direction per guidance mode (reference model.py:309-362: minimize
# entropy/uncertainty/crossent scores, maximize logit scores)
_GUIDANCE_SIGN = {
    "entropy": -1.0, "uncertainty": -1.0, "uncertainty_bond": -1.0,
    "entropy_bond": -1.0, "logit_bond": +1.0, "logit": +1.0,
    "crossent": -1.0, "crossent_bond": -1.0,
}


class MolDiffPreds(NamedTuple):
    pred_node: torch.Tensor      # [B, N, Kn] logits of v0
    pred_pos: torch.Tensor       # [B, N, 3]  x0 prediction
    pred_halfedge: torch.Tensor  # [B, E, Ke] logits of e0


class StepNoise(NamedTuple):
    """The random numbers of one reverse step (or of the prior draw)."""
    pos: torch.Tensor    # [B, N, 3] standard normal
    node: torch.Tensor   # [B, N, Kn] uniform [0, 1)
    edge: torch.Tensor   # [B, E, Ke] uniform [0, 1)


class LossNoise(NamedTuple):
    """The random numbers of one training loss: the time draw and the noise
    of the three forward noisings."""
    t: torch.Tensor      # [B] int timesteps (sample_time_antithetic)
    pos: torch.Tensor    # [B, N, 3] standard normal
    node: torch.Tensor   # [B, N, Kn] uniform [0, 1)
    edge: torch.Tensor   # [B, E, Ke] uniform [0, 1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of x over the elements where mask == 1 (moldiff.py:40-43).
    ``count``: the mask's sum (broadcast to x) over the whole batch, when
    this call sees only one rank's rows of it: the mean is then this rank's
    share of the batch's mean, and the shares sum to it over the ranks."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    count = torch.sum(mask) if count is None else count
    return torch.sum(x * mask) / torch.clamp(count, min=1.0)


def sample_time_antithetic(half: torch.Tensor, num_graphs: int,
                           num_timesteps: int) -> torch.Tensor:
    """Antithetic timesteps (moldiff.py:46-51) from ``half``, the
    num_graphs // 2 + 1 uniform integer draws in [0, num_timesteps)."""
    t = torch.cat([half, num_timesteps - half - 1])[:num_graphs]
    return t.to(torch.long)


class SampleState(NamedTuple):
    """A reverse chain's state; the continuous space's has no
    log-posteriors and no commit state (None)."""
    pos: torch.Tensor
    h_node: torch.Tensor
    h_halfedge: torch.Tensor
    log_node: Optional[torch.Tensor]
    log_halfedge: Optional[torch.Tensor]
    com_node: Optional[torch.Tensor]   # [B, N] committed class, -1 = not yet
    com_edge: Optional[torch.Tensor] = None   # [B, E] likewise; None = none yet
    preds: Optional[MolDiffPreds] = None


class Trajectory(NamedTuple):
    """A chain's states from the prior draw on, S + 1 of them. The classes
    are kept as indices (the discrete space's states are one-hots, so this
    is exact; the continuous space's keep their argmax): float32 one-hot
    half-edges of a B = 128, N = 40, T = 1000 chain would take 2.4 GB."""
    node: torch.Tensor       # [S+1, B, N] uint8 atom classes
    pos: torch.Tensor        # [S+1, B, N, 3]
    halfedge: torch.Tensor   # [S+1, B, E] uint8 bond classes


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
        # loss knobs (moldiff.py:74-95)
        self.bond_len_loss = bool(config.get("bond_len_loss", False))
        self.edge_loss_scale = float(config.get("edge_loss_scale", 1.0))
        self.v0_ce_scale = float(config.get("v0_ce_scale", 0.0))
        self.v0_ce_edge_scale = float(config.get("v0_ce_edge_scale", self.v0_ce_scale))
        diff = config["diff"]
        self.num_timesteps = diff["num_timesteps"]
        self.time_dim = diff["time_dim"]
        self.categorical_space = diff.get("categorical_space", "discrete")
        if self.categorical_space not in ("discrete", "continuous"):
            raise ValueError(self.categorical_space)
        # one-hot scaling of the continuous space (moldiff.py:103-106)
        self.scaling = [float(x) for x in diff.get("scaling", [1.0, 1.0, 1.0])]
        assert self.scaling[0] == 1, "scaling for pos must be 1"
        no_init = lambda d: {k: v for k, v in d.items() if k != "init_prob"}
        T = self.num_timesteps
        # the float64 schedules, kept for respacing (moldiff.py:121-123)
        self._raw_betas = {
            "pos": get_beta_schedule(num_timesteps=T, **diff["diff_pos"]),
            "node": get_beta_schedule(num_timesteps=T, **no_init(diff["diff_atom"])),
            "edge": get_beta_schedule(num_timesteps=T, **no_init(diff["diff_bond"])),
        }
        self._init_prob = {"node": diff["diff_atom"].get("init_prob"),
                           "edge": diff["diff_bond"].get("init_prob")}
        self._respace_cache = {}
        self.pos_transition, self.node_transition, self.edge_transition = \
            self._transitions(self._raw_betas)
        self.node_dim = config["node_dim"]
        self.edge_dim = config["edge_dim"]
        denoiser_cfg = dict(config["denoiser"])
        denoiser_cfg.pop("backbone", None)
        self._denoiser_cfg = denoiser_cfg
        self.denoiser_static = denoiser_static_config(**denoiser_cfg)
        self.time_emb = GaussianSmearing(stop=T, num_gaussians=self.time_dim, type_="linear")
        # (mesh, num_microbatches), set by the trainer on a (data, pipe) mesh:
        # the denoiser then runs as a GPipe pipeline over its stacked blocks
        # (parallel/pipeline.py; moldiff.py:150-155)
        self.pipeline_cfg = None
        # parallel/collectives.py PairSharding, set by the trainer on a mesh
        # with a graph axis: the denoiser then runs JAX's plain route with its
        # pair tensors' receiver axis split over graph, and split MLPs over
        # the model axis (models/denoiser.py; moldiff.py:148-151)
        self.pair_sharding = None

    def _transitions(self, betas: dict) -> tuple:
        """(Gaussian, node categorical, edge categorical) transitions of
        the float64 ``betas``, on the model's device; all three Gaussian in
        the continuous space (moldiff.py:131-137, :411-420)."""
        if self.categorical_space == "continuous":
            return (GaussianTransition(betas["pos"], device=self.device),
                    GaussianTransition(betas["node"], device=self.device,
                                       num_classes=self.num_node_types, scaling=self.scaling[1]),
                    GaussianTransition(betas["edge"], device=self.device,
                                       num_classes=self.num_edge_types, scaling=self.scaling[2]))
        return (GaussianTransition(betas["pos"], device=self.device),
                CategoricalTransition(betas["node"], self.num_node_types,
                                      init_prob=self._init_prob["node"], device=self.device),
                CategoricalTransition(betas["edge"], self.num_edge_types,
                                      init_prob=self._init_prob["edge"], device=self.device))

    def _respaced(self, num_steps: int, gamma: float = 1.0) -> tuple:
        """(transitions, t_map) of a ``num_steps``-step chain
        (moldiff.py:375-423): transitions built from the float64 betas
        composed over the kept timesteps, and t_map [S] (numpy int64), the
        original timestep each respaced step feeds the denoiser. Cached per
        (num_steps, gamma)."""
        key = (int(num_steps), float(gamma))
        if key not in self._respace_cache:
            subset = respace_timesteps(self.num_timesteps, num_steps, gamma)
            betas = {k: respaced_betas(v, subset) for k, v in self._raw_betas.items()}
            self._respace_cache[key] = (self._transitions(betas), subset)
        return self._respace_cache[key]

    # -- params --------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh float32 params on the model's device from ``generator``
        (moldiff.py:159-176): the embedders without bias, the denoiser and
        the two decoders."""
        dev = self.device
        denoiser, _ = init_node_edge_net(generator, self.node_dim, self.edge_dim, dev,
                                         **self._denoiser_cfg)
        return {
            "node_embedder": init_linear(generator, self.num_node_types,
                                         self.node_dim - self.time_dim, bias=False, device=dev),
            "edge_embedder": init_linear(generator, self.num_edge_types,
                                         self.edge_dim - self.time_dim, bias=False, device=dev),
            "denoiser": denoiser,
            "node_decoder": init_mlp(generator, self.node_dim, self.num_node_types,
                                     self.node_dim, device=dev),
            "edge_decoder": init_mlp(generator, self.edge_dim, self.num_edge_types,
                                     self.edge_dim, device=dev),
        }

    # -- denoiser forward ----------------------------------------------------

    def prepare(self, params: dict) -> list:
        """Per-block params in the compute dtype (denoiser.prepare_blocks),
        made once per sampling run and passed to :meth:`forward`."""
        return prepare_blocks(params["denoiser"], self.denoiser_static)

    def forward(self, params: dict, h_node_pert, pos_pert, h_halfedge_pert, t, node_mask,
                blocks: Optional[list] = None, return_moe_aux: bool = False):
        """Predict the clean (t = 0) quantities (moldiff.py:178-249).
        h_node_pert [B,N,Kn], pos_pert [B,N,3], h_halfedge_pert [B,E,Ke],
        t [B] int, node_mask [B,N]. ``return_moe_aux``: (preds, the MoE
        load-balance scalar or None)."""
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
        if self.pipeline_cfg is not None:
            from ..parallel.pipeline import pipeline_denoiser

            pipe_mesh, n_micro = self.pipeline_cfg
            out = pipeline_denoiser(params["denoiser"], self.denoiser_static, h_node, pos_pert,
                                    h_edge, node_time=t_norm, edge_time=t_norm,
                                    pair_mask=pair_mask, mesh=pipe_mesh,
                                    num_microbatches=n_micro)
        else:
            out = node_edge_net(params["denoiser"], self.denoiser_static, h_node, pos_pert,
                                h_edge, node_time=t_norm, edge_time=t_norm, pair_mask=pair_mask,
                                blocks=blocks, node_mask=node_mask,
                                pair_sharding=self.pair_sharding)
        h_node, pos_out, h_edge = out[:3]
        tp = self.pair_sharding.model if self.pair_sharding is not None else None
        pred_node = mlp(params["node_decoder"], h_node, tp)
        h_half_sym = graph_ops.dense_to_halfedge(graph_ops.symmetrize_dense(h_edge))
        pred_halfedge = mlp(params["edge_decoder"], h_half_sym, tp)
        preds = MolDiffPreds(pred_node, pos_out, pred_halfedge)
        if return_moe_aux:
            return preds, (out[3] if len(out) > 3 else None)
        return preds

    # -- training loss ---------------------------------------------------------

    def _class_draw(self):
        """The draw of the class chains' noise: uniform for the categorical
        transitions, standard normal in the continuous space."""
        return torch.randn if self.categorical_space == "continuous" else torch.rand

    def draw_loss_noise(self, b: int, n: int, generator: torch.Generator) -> LossNoise:
        """Fresh noise for one :meth:`get_loss` on a [B, N] batch."""
        dev = self.device
        half = torch.randint(0, self.num_timesteps, (b // 2 + 1,), generator=generator,
                             device=dev)
        draw = self._class_draw()
        return LossNoise(
            t=sample_time_antithetic(half, b, self.num_timesteps),
            pos=torch.randn((b, n, 3), generator=generator, device=dev),
            node=draw((b, n, self.num_node_types), generator=generator, device=dev),
            edge=draw((b, graph_ops.num_halfedges(n), self.num_edge_types),
                      generator=generator, device=dev),
        )

    def loss_counts(self, node_type, halfedge_type, node_mask) -> dict:
        """The denominators of :meth:`get_loss`'s masked means on this
        batch: they depend on the masks alone, so a data-parallel step sums
        them over the ranks before the forward pass."""
        n_kn = self.num_node_types if self.categorical_space == "continuous" else 1
        n_ke = self.num_edge_types if self.categorical_space == "continuous" else 1
        halfedge_mask = graph_ops.halfedge_mask_from_node_mask(node_mask)
        nodes, halfedges = torch.sum(node_mask), torch.sum(halfedge_mask)
        out = {"pos": 3.0 * nodes, "node": n_kn * nodes, "edge": n_ke * halfedges}
        if self.bond_len_loss:
            out["len"] = torch.sum(halfedge_mask * (halfedge_type > 0))
        return out

    def get_loss(self, params: dict, node_type, node_pos, halfedge_type, node_mask,
                 noise: LossNoise, counts: Optional[dict] = None):
        """Diffusion training loss (moldiff.py:253-373): masked-mean position
        MSE + 100 x KL(node) + 100 x edge_loss_scale x KL(edge) (in the
        continuous space 30 x the MSE to the scaled one-hots of each) [+
        bond-length MSE] [+ v0 cross-entropy] [+ aux_weight x the MoE
        load-balance loss, ``loss_moe``]. node_type [B,N] int, node_pos [B,N,3],
        halfedge_type [B,E] int, node_mask [B,N] -> (loss, dict of terms).
        ``counts``: :meth:`loss_counts` summed over the ranks that split the
        batch (each term is then this rank's share of the batch's)."""
        n = node_type.shape[1]
        c = counts or {}
        halfedge_mask = graph_ops.halfedge_mask_from_node_mask(node_mask)
        t = noise.t
        pos_pert = self.pos_transition.add_noise(node_pos, t, noise.pos)
        node_tr, edge_tr = self.node_transition, self.edge_transition
        if self.categorical_space == "continuous":
            h_node_pert, h_node_0 = node_tr.add_noise(node_type, t, noise.node)
            h_halfedge_pert, h_halfedge_0 = edge_tr.add_noise(halfedge_type, t, noise.edge)
        else:
            h_node_pert, log_node_t, log_node_0 = node_tr.add_noise(node_type, t, noise.node)
            h_halfedge_pert, log_halfedge_t, log_halfedge_0 = edge_tr.add_noise(
                halfedge_type, t, noise.edge)
        preds, moe_aux = self.forward(params, h_node_pert, pos_pert, h_halfedge_pert, t,
                                      node_mask, return_moe_aux=True)

        loss_pos = masked_mean((preds.pred_pos - node_pos) ** 2, node_mask[..., None],
                               c.get("pos"))
        losses = {}
        if self.bond_len_loss:
            iu, ju = (torch.as_tensor(a, dtype=torch.long, device=node_pos.device)
                      for a in graph_ops.triu_indices(n))
            bond_mask = halfedge_mask * (halfedge_type > 0)
            true_len = safe_distance(node_pos[:, iu] - node_pos[:, ju])
            pred_len = safe_distance(preds.pred_pos[:, iu] - preds.pred_pos[:, ju])
            losses["loss_len"] = masked_mean((pred_len - true_len) ** 2, bond_mask, c.get("len"))

        if self.categorical_space == "continuous":
            # MSE to the scaled one-hots x 30 (moldiff.py:347-356)
            loss_node = masked_mean((preds.pred_node - h_node_0) ** 2, node_mask[..., None],
                                    c.get("node")) * 30.0
            loss_edge = masked_mean((preds.pred_halfedge - h_halfedge_0) ** 2,
                                    halfedge_mask[..., None], c.get("edge")) * 30.0
        else:
            log_node_recon = torch.log_softmax(preds.pred_node, dim=-1)
            kl_node = node_tr.compute_v_Lt(node_tr.q_v_posterior(log_node_0, log_node_t, t),
                                           node_tr.q_v_posterior(log_node_recon, log_node_t, t),
                                           log_node_0, t)
            loss_node = masked_mean(kl_node, node_mask, c.get("node")) * 100.0
            log_edge_recon = torch.log_softmax(preds.pred_halfedge, dim=-1)
            kl_edge = edge_tr.compute_v_Lt(
                edge_tr.q_v_posterior(log_halfedge_0, log_halfedge_t, t),
                edge_tr.q_v_posterior(log_edge_recon, log_halfedge_t, t), log_halfedge_0, t)
            loss_edge = (masked_mean(kl_edge, halfedge_mask, c.get("edge")) * 100.0
                         * self.edge_loss_scale)
            if self.v0_ce_scale > 0 or self.v0_ce_edge_scale > 0:
                loss_v0ce = 0.0
                if self.v0_ce_scale > 0:
                    ce_node = -torch.gather(log_node_recon, -1,
                                            node_type[..., None].long())[..., 0]
                    loss_v0ce = loss_v0ce + self.v0_ce_scale * masked_mean(ce_node, node_mask,
                                                                          c.get("node"))
                if self.v0_ce_edge_scale > 0:
                    ce_edge = -torch.gather(log_edge_recon, -1,
                                            halfedge_type[..., None].long())[..., 0]
                    loss_v0ce = loss_v0ce + self.v0_ce_edge_scale * masked_mean(
                        ce_edge, halfedge_mask, c.get("edge"))
                losses["loss_v0ce"] = loss_v0ce
        if moe_aux is not None:
            # the Switch load-balance loss, weighted by denoiser.moe.aux_weight
            losses["loss_moe"] = self.denoiser_static["moe"]["aux_weight"] * moe_aux
        loss_total = (loss_pos + loss_node + loss_edge + losses.get("loss_len", 0.0)
                      + losses.get("loss_v0ce", 0.0) + losses.get("loss_moe", 0.0))
        losses.update(loss=loss_total, loss_pos=loss_pos, loss_node=loss_node,
                      loss_edge=loss_edge)
        return loss_total, losses

    # -- sampling --------------------------------------------------------------

    def draw_noise(self, b: int, n: int, generator: torch.Generator) -> StepNoise:
        e = graph_ops.num_halfedges(n)
        dev = self.device
        draw = self._class_draw()
        return StepNoise(
            pos=torch.randn((b, n, 3), generator=generator, device=dev),
            node=draw((b, n, self.num_node_types), generator=generator, device=dev),
            edge=draw((b, e, self.num_edge_types), generator=generator, device=dev),
        )

    def init_state(self, node_mask: torch.Tensor, noise: StepNoise) -> SampleState:
        """The prior draw x_T, v_T, e_T (moldiff.py:513-517; in the
        continuous space all three standard normal, :896-899, and no
        log-posteriors or commit state)."""
        b, n = node_mask.shape
        e = graph_ops.num_halfedges(n)
        if self.categorical_space == "continuous":
            return SampleState(self.pos_transition.sample_init(noise.pos),
                               self.node_transition.sample_init(noise.node),
                               self.edge_transition.sample_init(noise.edge), None, None, None)
        _, h_node, log_node = self.node_transition.sample_init((b, n), noise.node)
        pos = self.pos_transition.sample_init(noise.pos)
        _, h_half, log_half = self.edge_transition.sample_init((b, e), noise.edge)
        com_node = torch.full((b, n), -1, dtype=torch.long, device=node_mask.device)
        com_edge = torch.full((b, e), -1, dtype=torch.long, device=node_mask.device)
        return SampleState(pos, h_node, h_half, log_node, log_half, com_node, com_edge)

    def reverse_step(self, params: dict, state: SampleState, step: int, node_mask,
                     noise: StepNoise, commit: str = "none",
                     blocks: Optional[list] = None, bond_predictor=None,
                     guidance: Optional[Tuple[str, float]] = None, guidance_interval: int = 1,
                     edge_guidance: float = 0.0,
                     edge_guidance_tmax: Optional[int] = None,
                     transitions: Optional[tuple] = None, t_model: Optional[int] = None,
                     pos_sampler: str = "ddpm", eta: float = 0.0) -> SampleState:
        """One ancestral reverse step at chain index ``step`` (the scan body
        of moldiff.py:559-755).

        ``transitions`` (pos, node, edge) and ``t_model``: a respaced
        chain's (:meth:`_respaced`). The posterior math and the commit gate
        run on the transitions at index ``step``; the denoiser, both kinds
        of guidance and the ``edge_guidance_tmax`` gate read ``t_model``,
        the original timestep (``step`` on a full chain).
        ``pos_sampler``: "ddpm" or "ddim" with noise level ``eta``.
        ``commit``: "nodes" / "edges" / "both" freeze an atom's / half-edge's
        first model-driven non-sentinel draw (moldiff.py:582-717).
        ``bond_predictor``: (BondPredictor, params, blocks or None), needed by
        ``guidance`` (mode, scale: the position drift of
        :func:`bond_guidance_delta`, applied when ``step % guidance_interval
        == 0``) and ``edge_guidance`` (weight of the predictor's log-probs
        mixed into the edge v0 prediction, at timesteps below
        ``edge_guidance_tmax`` when given).
        In the continuous space the step is :meth:`_continuous_step`."""
        if commit not in COMMIT_MODES:
            raise ValueError(f"commit must be one of {COMMIT_MODES}, got {commit!r}")
        if pos_sampler not in POS_SAMPLERS:
            raise ValueError(f"pos_sampler must be one of {POS_SAMPLERS}, got {pos_sampler!r}")
        edge_guidance = float(edge_guidance)
        if (edge_guidance > 0 or guidance is not None) and bond_predictor is None:
            raise ValueError("guidance and edge_guidance require a bond_predictor")
        if self.categorical_space == "continuous":
            self._check_continuous(edge_guidance)
            return self._continuous_step(params, state, step, node_mask, noise, blocks,
                                         bond_predictor, guidance, transitions, t_model)
        commit_nodes = commit in ("nodes", "both")
        commit_edges = commit in ("edges", "both")
        pos_tr, node_tr, edge_tr = transitions or (
            self.pos_transition, self.node_transition, self.edge_transition)
        b = node_mask.shape[0]
        dev = node_mask.device
        t = torch.full((b,), step, dtype=torch.long, device=dev)
        t_model = t if t_model is None else torch.full((b,), int(t_model), dtype=torch.long,
                                                       device=dev)
        preds = self.forward(params, state.h_node, state.pos, state.h_halfedge, t_model, node_mask,
                             blocks=blocks)
        if pos_sampler == "ddim":
            pos_prev = pos_tr.ddim_prev(state.pos, preds.pred_pos, t, noise.pos, eta=float(eta))
        else:
            pos_prev = pos_tr.get_prev_from_recon(state.pos, preds.pred_pos, t, noise.pos)

        log_node_recon = torch.log_softmax(preds.pred_node, dim=-1)
        com_node = state.com_node
        if commit_nodes:
            log_node_recon = _clamp_committed(log_node_recon, com_node)
        log_node_new = node_tr.q_v_posterior(log_node_recon, state.log_node, t)
        node_type_prev = log_sample_categorical(log_node_new, noise.node)
        if commit_nodes:
            com_node, node_type_prev = _commit(node_tr, step, log_node_recon, node_type_prev,
                                               com_node, sentinel=self.num_node_types - 1)

        log_edge_recon = torch.log_softmax(preds.pred_halfedge, dim=-1)
        if edge_guidance > 0:
            # class-space bond guidance (moldiff.py:650-675)
            bp, bp_params, bp_blocks = bond_predictor
            bp_logits = bp.forward(bp_params, state.h_node, state.pos, t_model, node_mask,
                                   blocks=bp_blocks)
            bp_logp = torch.log_softmax(bp_logits, dim=-1)
            pad = self.num_edge_types - bp_logp.shape[-1]
            if pad > 0:
                # mask classes: uniform level, neither boosted nor killed
                bp_logp = torch.nn.functional.pad(
                    bp_logp, (0, pad), value=-float(np.log(bp_logits.shape[-1])))
            mix = edge_guidance * bp_logp
            if edge_guidance_tmax is not None:
                mix = torch.where((t_model < int(edge_guidance_tmax))[:, None, None], mix,
                                  torch.zeros_like(mix))
            log_edge_recon = torch.log_softmax(log_edge_recon + mix, dim=-1)
            preds = MolDiffPreds(preds.pred_node, preds.pred_pos, log_edge_recon)
        com_edge = state.com_edge
        if commit_edges:
            if com_edge is None:
                com_edge = torch.full(log_edge_recon.shape[:2], -1, dtype=torch.long, device=dev)
            log_edge_recon = _clamp_committed(log_edge_recon, com_edge)
        log_half_new = edge_tr.q_v_posterior(log_edge_recon, state.log_halfedge, t)
        half_type_prev = log_sample_categorical(log_half_new, noise.edge)
        if commit_edges:
            # the edge sentinel is class 0, the 'absorb' prior's (moldiff.py:586-587)
            com_edge, half_type_prev = _commit(edge_tr, step, log_edge_recon, half_type_prev,
                                               com_edge, sentinel=0)
        if commit_nodes or commit_edges:
            # decode reads the clamped v0 views (moldiff.py:702-708)
            preds = MolDiffPreds(log_node_recon, preds.pred_pos, log_edge_recon)
        if guidance is not None and not float(guidance[1]) <= 0:
            if guidance_interval <= 1 or step % guidance_interval == 0:
                pos_prev = pos_prev + bond_guidance_delta(
                    bond_predictor, guidance[0], float(guidance[1]), state.h_node, state.pos,
                    t_model, node_mask, half_type_prev, log_half_new)
        return SampleState(pos_prev, node_tr.onehot_encode(node_type_prev),
                           edge_tr.onehot_encode(half_type_prev), log_node_new, log_half_new,
                           com_node, com_edge, preds)

    def _check_continuous(self, edge_guidance: float) -> None:
        """The port's one departure in the continuous space: JAX dispatches
        to its sampler before it reads ``edge_guidance`` and so ignores it
        (moldiff.py:502-506); the port refuses it."""
        if float(edge_guidance) > 0:
            raise ValueError("edge_guidance acts on the categorical bond posterior; the "
                             "continuous categorical space has none")

    def _continuous_step(self, params: dict, state: SampleState, step: int, node_mask,
                         noise: StepNoise, blocks: Optional[list] = None, bond_predictor=None,
                         guidance: Optional[Tuple[str, float]] = None,
                         transitions: Optional[tuple] = None,
                         t_model: Optional[int] = None) -> SampleState:
        """One reverse step of the continuous space (the scan body of
        moldiff.py:906-942): positions, atom and bond features each drawn
        from its Gaussian posterior given the x0 prediction, ``noise`` all
        standard normal; with ``guidance`` the position drift of
        :func:`bond_guidance_delta` at every step, its bond inputs the argmax
        and log-softmax of the new bond features."""
        pos_tr, node_tr, edge_tr = transitions or (
            self.pos_transition, self.node_transition, self.edge_transition)
        b = node_mask.shape[0]
        dev = node_mask.device
        t = torch.full((b,), step, dtype=torch.long, device=dev)
        t_model = t if t_model is None else torch.full((b,), int(t_model), dtype=torch.long,
                                                       device=dev)
        preds = self.forward(params, state.h_node, state.pos, state.h_halfedge, t_model, node_mask,
                             blocks=blocks)
        pos_prev = pos_tr.get_prev_from_recon(state.pos, preds.pred_pos, t, noise.pos)
        h_node_prev = node_tr.get_prev_from_recon(state.h_node, preds.pred_node, t, noise.node)
        h_half_prev = edge_tr.get_prev_from_recon(state.h_halfedge, preds.pred_halfedge, t,
                                                  noise.edge)
        if guidance is not None and not float(guidance[1]) <= 0:
            pos_prev = pos_prev + bond_guidance_delta(
                bond_predictor, guidance[0], float(guidance[1]), state.h_node, state.pos,
                t_model, node_mask, torch.argmax(h_half_prev, dim=-1),
                torch.log_softmax(h_half_prev, dim=-1))
        return SampleState(pos_prev, h_node_prev, h_half_prev, None, None, None, None, preds)

    @torch.no_grad()
    def sample(self, params: dict, node_mask: torch.Tensor, generator: torch.Generator,
               commit: str = "none", bond_predictor=None,
               guidance: Optional[Tuple[str, float]] = None, guidance_interval: int = 1,
               edge_guidance: float = 0.0,
               edge_guidance_tmax: Optional[int] = None, num_steps: Optional[int] = None,
               respace_gamma: float = 1.0, pos_sampler: str = "ddpm", eta: float = 0.0,
               save_traj: bool = False):
        """The reverse chain (moldiff.py:425-548); returns the final step's
        predictions, which decoding reads, and with ``save_traj`` also the
        :class:`Trajectory` (the prior state first, moldiff.py:541-547).
        ``num_steps`` below T runs a respaced chain of that many steps
        (spacing warped by ``respace_gamma``); None or at least T, the full
        chain. ``bond_predictor``: (BondPredictor, params); see
        :meth:`reverse_step` for the rest."""
        if self.categorical_space == "continuous":
            self._check_continuous(edge_guidance)
        b, n = node_mask.shape
        blocks = self.prepare(params)
        if bond_predictor is not None:
            bp, bp_params = bond_predictor[:2]
            bond_predictor = (bp, bp_params, bp.prepare(bp_params))
        transitions, t_map = None, None
        steps = self.num_timesteps
        if num_steps is not None and num_steps < steps:
            transitions, t_map = self._respaced(num_steps, respace_gamma)
            steps = int(num_steps)
        state = self.init_state(node_mask, self.draw_noise(b, n, generator))
        traj = [] if save_traj else None
        for step in range(steps - 1, -1, -1):
            if traj is not None:
                traj.append(_traj_entry(state))
            state = self.reverse_step(params, state, step, node_mask,
                                      self.draw_noise(b, n, generator), commit=commit,
                                      blocks=blocks, bond_predictor=bond_predictor,
                                      guidance=guidance, guidance_interval=guidance_interval,
                                      edge_guidance=edge_guidance,
                                      edge_guidance_tmax=edge_guidance_tmax,
                                      transitions=transitions,
                                      t_model=None if t_map is None else int(t_map[step]),
                                      pos_sampler=pos_sampler, eta=eta)
        if traj is None:
            return state.preds
        traj.append(_traj_entry(state))
        return state.preds, Trajectory(*(torch.stack(x) for x in zip(*traj)))


def _traj_entry(state: SampleState) -> tuple:
    """(atom classes, positions, bond classes) of a state for a
    :class:`Trajectory`: the argmax of its features (in the continuous
    space the classes decoding would read, not the features)."""
    return (state.h_node.argmax(-1).to(torch.uint8), state.pos,
            state.h_halfedge.argmax(-1).to(torch.uint8))


def _clamp_committed(log_recon: torch.Tensor, committed: torch.Tensor) -> torch.Tensor:
    """A committed element's v0 input to the posterior is its committed
    class, not the model's fresh prediction (moldiff.py:606-614)."""
    return torch.where((committed >= 0)[..., None],
                       index_to_log_onehot(torch.clamp(committed, min=0), log_recon.shape[-1]),
                       log_recon)


def _commit(transition: CategoricalTransition, step: int, log_recon: torch.Tensor,
            drawn: torch.Tensor, committed: torch.Tensor, sentinel: int) -> tuple:
    """Freeze a draw when the model term of the reveal jump beats the
    prior-leak term for the drawn class (moldiff.py:623-642, :692-700);
    committed elements never flip back. Returns (committed, drawn)."""
    abar = transition.alphas_bar[max(step - 1, 0)]
    p_drawn = torch.gather(torch.exp(log_recon), -1, drawn[..., None])[..., 0]
    pi_drawn = transition.init_prob[drawn]
    reveal = ((committed < 0) & (drawn != sentinel)
              & (abar * p_drawn > (1.0 - abar) * pi_drawn))
    committed = torch.where(reveal, drawn, committed)
    return committed, torch.where(committed >= 0, committed, drawn)


def _guidance_score(gui_type: str, pred: torch.Tensor, halfedge_mask: torch.Tensor,
                    halfedge_type_prev: torch.Tensor,
                    log_halfedge_type: torch.Tensor) -> torch.Tensor:
    """The scalar whose position gradient guides (moldiff.py:992-1041);
    every per-half-edge term masked so padding contributes nothing."""
    eps = 1e-12
    k = pred.shape[-1]
    if gui_type in ("entropy", "entropy_bond"):
        prob = torch.softmax(pred, dim=-1)
        score = torch.log(-(prob * torch.log(prob + eps)).sum(dim=-1))
    elif gui_type in ("uncertainty", "uncertainty_bond"):
        prob = torch.softmax(pred, dim=-1)
        score = torch.log(torch.sigmoid(-torch.logsumexp(pred, dim=-1)))
    elif gui_type in ("logit_bond", "logit"):
        keep = ((halfedge_type_prev >= 1) & (halfedge_type_prev <= 4) if gui_type == "logit_bond"
                else halfedge_type_prev <= 4).to(pred.dtype)
        sel = torch.gather(pred, -1, torch.clamp(halfedge_type_prev, 0, k - 1)[..., None])[..., 0]
        return (sel * keep * halfedge_mask).sum()
    elif gui_type == "crossent":
        target = torch.exp(log_halfedge_type)[..., :-1].detach()
        ce = -(target * torch.log_softmax(pred, dim=-1)).sum(dim=-1)
        score = torch.log(ce + eps)
    elif gui_type == "crossent_bond":
        target = torch.exp(log_halfedge_type)[..., 1:-1].detach()
        ce = -(target * torch.log_softmax(pred[..., 1:], dim=-1)).sum(dim=-1)
        score = torch.log(ce + eps)
    else:
        raise NotImplementedError(f"guidance type {gui_type}")
    if gui_type.endswith("_bond") and gui_type != "crossent_bond":
        # weight by the predicted probability of any bond (no gradient)
        return (score * prob[..., 1:].sum(dim=-1).detach() * halfedge_mask).sum()
    return (score * halfedge_mask).sum()


def bond_guidance_delta(bond_predictor, gui_type: str, gui_scale: float,
                        h_node_pert: torch.Tensor, pos_pert: torch.Tensor, t: torch.Tensor,
                        node_mask: torch.Tensor, halfedge_type_prev: torch.Tensor,
                        log_halfedge_type: torch.Tensor) -> torch.Tensor:
    """delta(pos) = +-grad_pos(score) * scale for the eight reference modes
    (moldiff.py:970-1044). ``bond_predictor``: (BondPredictor, params[,
    blocks]). The predictor's forward and its gradient run with autograd
    on, also inside ``torch.no_grad()``."""
    if gui_type not in _GUIDANCE_SIGN:
        raise NotImplementedError(f"guidance type {gui_type}")
    bp, bp_params = bond_predictor[:2]
    blocks = bond_predictor[2] if len(bond_predictor) > 2 else None
    halfedge_mask = graph_ops.halfedge_mask_from_node_mask(node_mask)
    with torch.enable_grad():
        pos_in = pos_pert.detach().requires_grad_(True)
        pred = bp.forward(bp_params, h_node_pert, pos_in, t, node_mask, blocks=blocks)
        score = _guidance_score(gui_type, pred, halfedge_mask, halfedge_type_prev,
                                log_halfedge_type)
        grad, = torch.autograd.grad(score, pos_in)
    return _GUIDANCE_SIGN[gui_type] * grad * gui_scale
