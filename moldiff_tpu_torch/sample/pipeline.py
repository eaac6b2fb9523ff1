"""Host-side sampling pipeline: generate until N molecules
(moldiff_tpu/sample/pipeline.py).

  draw sizes ~ N(24.9, 5.5) -> group by bucket -> per-bucket fixed-size
  batches of the reverse chain -> unpad -> decode -> sanitize cascade ->
  pool {finished, failed}

The chains run every mode of ``MolDiff.sample``: full or respaced
(``num_steps``, ``respace_gamma``), ``ddpm`` or ``ddim`` positions,
``commit``. With a bond predictor they are guided (positions by its
gradient, edge classes by its log-probs); ``add_edge`` re-perceives bonds
from the final positions instead of reading the model's. ``generate`` keeps
the trajectories of a Bernoulli share of the finished molecules.

Failed molecules (reconstruction error or disconnected SMILES) are kept in
the ``failed`` pool, and generation stops once failures exceed
``max_failures_factor`` times the requested count. With ``recon_workers``
above 1 each ``generate`` call classifies every batch through a pool of
that many spawned processes (sample/classify.py), opened at the start of
the call and shut down at its end; 0, 1 or None classify in this process.
The pooled entries are the serial ones, in order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import time

import numpy as np
import torch

from ..data.batching import (DEFAULT_BUCKETS, node_mask_from_counts, split_trajectories,
                             unpad_arrays)
from ..data.featurize import GEOM_DRUG_SIZE_MEAN, GEOM_DRUG_SIZE_STD, MolFeaturizer
from ..models.moldiff import COMMIT_MODES, POS_SAMPLERS
from .classify import classify_batch, classify_decoded, make_classify_pool


ADD_EDGE_MODES = (None, "distance", "edm", "connect")


class MolSampler:
    """A MolDiff model with the bucketed batching and the decode/classify path."""

    def __init__(self, model, featurizer: MolFeaturizer,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, batch_size: int = 128,
                 size_mean: float = GEOM_DRUG_SIZE_MEAN, size_std: float = GEOM_DRUG_SIZE_STD,
                 sanitize_mode: str = "reference", commit: str = "none",
                 bond_predictor=None, guidance: Optional[Tuple[str, float]] = None,
                 guidance_interval: int = 1, edge_guidance: float = 0.0,
                 edge_guidance_tmax: Optional[int] = None, add_edge: Optional[str] = None,
                 num_steps: Optional[int] = None, pos_sampler: str = "ddpm", eta: float = 0.0,
                 respace_gamma: float = 1.0, recon_workers: Optional[int] = 0):
        if (guidance is not None or edge_guidance > 0) and bond_predictor is None:
            raise ValueError("guidance and edge_guidance require a bond_predictor")
        if add_edge not in ADD_EDGE_MODES:
            raise ValueError(f"add_edge must be one of {ADD_EDGE_MODES}, got {add_edge!r}")
        if pos_sampler not in POS_SAMPLERS:
            raise ValueError(f"pos_sampler must be one of {POS_SAMPLERS}, got {pos_sampler!r}")
        if commit not in COMMIT_MODES:
            raise ValueError(f"commit must be one of {COMMIT_MODES}, got {commit!r}")
        self.model = model
        self.featurizer = featurizer
        self.buckets = tuple(sorted(buckets))
        self.batch_size = batch_size
        self.size_mean = size_mean
        self.size_std = size_std
        self.sanitize_mode = sanitize_mode
        self.commit = commit
        self.bond_predictor = bond_predictor   # (BondPredictor, params) or None
        self.guidance = guidance
        self.guidance_interval = guidance_interval
        self.edge_guidance = float(edge_guidance)
        # edge guidance only at timesteps t < tmax; a falsy tmax (None or 0)
        # means every step (pipeline.py:105-106)
        self.edge_guidance_tmax = int(edge_guidance_tmax) if edge_guidance_tmax else None
        self.add_edge = add_edge
        # respaced chain of num_steps steps (None: the full chain), the
        # position sampler and its noise level, the spacing warp
        # (pipeline.py:33-93)
        self.num_steps = int(num_steps) if num_steps else None
        self.pos_sampler = pos_sampler
        self.eta = float(eta)
        self.respace_gamma = float(respace_gamma)
        # host classification workers: 0, 1 or None classify serially
        # (pipeline.py:109-115)
        self.recon_workers = int(recon_workers or 0)
        self.chains = 0        # reverse chains run so far
        self.chain_s = 0.0     # wall time of those chains, device work included

    @property
    def steps(self) -> int:
        """Reverse steps per chain."""
        return min(self.num_steps or self.model.num_timesteps, self.model.num_timesteps)

    def set_guidance_scale(self, scale: float) -> None:
        """Change the guidance scale for later chains (pipeline.py:128-136);
        the guidance mode stays the sampler's."""
        if self.guidance is None:
            raise ValueError("sampler was built without guidance")
        self.guidance = (self.guidance[0], float(scale))

    def chain_kwargs(self) -> dict:
        """The sampler's per-step settings, as ``MolDiff.sample`` and
        ``MolDiff.reverse_step`` take them."""
        kw = {"commit": self.commit, "pos_sampler": self.pos_sampler, "eta": self.eta}
        if self.bond_predictor is not None:
            kw.update(bond_predictor=self.bond_predictor, guidance=self.guidance,
                      guidance_interval=self.guidance_interval,
                      edge_guidance=self.edge_guidance,
                      edge_guidance_tmax=self.edge_guidance_tmax)
        return kw

    def draw_sizes(self, n_graphs: int, rng: np.random.Generator) -> np.ndarray:
        """Sizes ~ N(mean, std) clipped to [3, largest bucket]."""
        sizes = rng.normal(self.size_mean, self.size_std, size=n_graphs)
        return np.clip(sizes.astype(np.int64), 3, self.buckets[-1])

    def sample_sizes(self, params, sizes: np.ndarray, generator: torch.Generator,
                     save_traj: bool = False):
        """Reverse chains for molecules of the given sizes -> per-molecule
        decoded dicts (pre-sanitize). Each bucket runs in batches of
        ``batch_size``, padded with throwaway 3-atom graphs. With
        ``save_traj`` returns (decoded, refs): ``refs[i]`` fetches molecule
        i's trajectory on demand (:class:`TrajectoryBatch`), so only the
        molecules that keep one leave the device (pipeline.py:237-261)."""
        out: List[dict] = [None] * len(sizes)
        refs: List[Optional[tuple]] = [None] * len(sizes)
        by_bucket: Dict[int, List[int]] = {}
        for idx in np.argsort(sizes, kind="stable"):
            n = int(sizes[idx])
            by_bucket.setdefault(next(bk for bk in self.buckets if n <= bk), []).append(int(idx))
        for n_bucket, idxs in sorted(by_bucket.items()):
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                counts = np.array([sizes[i] for i in chunk], dtype=np.int32)
                pad = self.batch_size - len(chunk)
                if pad:
                    counts = np.concatenate([counts, np.full(pad, 3, np.int32)])
                node_mask = torch.from_numpy(node_mask_from_counts(counts, n_bucket)).to(
                    self.model.device)
                t0 = time.perf_counter()
                preds = self.model.sample(params, node_mask, generator, save_traj=save_traj,
                                          num_steps=self.num_steps,
                                          respace_gamma=self.respace_gamma,
                                          **self.chain_kwargs())
                if save_traj:
                    preds, traj = preds
                    batch = TrajectoryBatch(traj, counts, self.model.num_node_types,
                                            self.model.num_edge_types)
                    for local_i, global_i in enumerate(chunk):
                        refs[global_i] = (batch, local_i)
                host = {k: v.float().cpu().numpy() for k, v in preds._asdict().items()}
                self.chain_s += time.perf_counter() - t0
                self.chains += 1
                per_mol = unpad_arrays(host, counts)
                for local_i, global_i in enumerate(chunk):
                    p = per_mol[local_i]
                    out[global_i] = self.featurizer.decode_output(
                        p["pred_node"], p["pred_pos"], p["pred_halfedge"])
        return (out, refs) if save_traj else out

    def generate(self, params, num_mols: int, generator: torch.Generator,
                 rng: Optional[np.random.Generator] = None, max_failures_factor: int = 3,
                 batch_graphs: Optional[int] = None, logger=None,
                 traj_prob: float = 0.0) -> Dict[str, list]:
        """Generate until ``num_mols`` molecules are finished. Returns the
        pool {'finished': [...], 'failed': [...]} of classify_decoded
        entries, 'finished' cut to ``num_mols``, and under 'classified' the
        counts of every molecule classified before that cut.
        ``traj_prob``: each finished molecule keeps its trajectory (entry
        'traj': 'node' [S+1, n, Kn], 'pos' [S+1, n, 3], 'halfedge'
        [S+1, e, Ke]) with this probability, drawn from ``rng`` in the JAX
        pipeline's order (pipeline.py:361-407), so one seed keeps the same
        molecules' trajectories."""
        rng = rng or np.random.default_rng(0)
        batch_graphs = batch_graphs or self.batch_size
        workers = make_classify_pool(self.recon_workers)
        try:
            return self._generate_loop(params, num_mols, generator, rng, max_failures_factor,
                                       batch_graphs, logger, traj_prob, workers)
        finally:
            if workers is not None:
                workers.shutdown(cancel_futures=True)

    def _generate_loop(self, params, num_mols, generator, rng, max_failures_factor,
                       batch_graphs, logger, traj_prob, workers) -> Dict[str, list]:
        save_traj = traj_prob > 0.0
        pool = {"finished": [], "failed": []}
        while len(pool["finished"]) < num_mols:
            if len(pool["failed"]) > max_failures_factor * num_mols:
                if logger:
                    logger("too many failed molecules, aborting")
                break
            sizes = self.draw_sizes(batch_graphs, rng)
            if save_traj:
                decoded, refs = self.sample_sizes(params, sizes, generator, save_traj=True)
            else:
                decoded, refs = self.sample_sizes(params, sizes, generator), None
            if workers is None:
                entries = [classify_decoded(d, add_edge=self.add_edge,
                                            sanitize_mode=self.sanitize_mode) for d in decoded]
            else:
                entries = classify_batch(decoded, self.add_edge, workers, self.sanitize_mode)
            if save_traj:
                keep = [(e, ref) for e, ref in zip(entries, refs)
                        if e["pool"] == "finished" and rng.random() < traj_prob]
                for batch in {id(ref[0]): ref[0] for _, ref in keep}.values():
                    batch.prefetch([i for _, (bt, i) in keep if bt is batch])
                for e, (batch, i) in keep:
                    e["traj"] = batch.fetched[i]
            for entry in entries:
                pool[entry["pool"]].append(entry)
            if logger:
                logger(f"pool: finished {len(pool['finished'])} | failed {len(pool['failed'])}")
        pool["classified"] = {"finished": len(pool["finished"]), "failed": len(pool["failed"])}
        pool["finished"] = pool["finished"][:num_mols]
        return pool


class TrajectoryBatch:
    """One chain's :class:`~..models.moldiff.Trajectory`, left on the device
    until molecules of it are asked for (pipeline.py:410-446): those are
    gathered there, copied to the host and their class indices expanded to
    the JAX layout's one-hots."""

    def __init__(self, traj, counts: np.ndarray, num_node_types: int, num_edge_types: int):
        self.traj = traj
        self.counts = counts
        self.num_classes = (num_node_types, num_edge_types)
        self.fetched: Dict[int, dict] = {}

    def prefetch(self, local_idxs: Sequence[int]) -> None:
        idxs = sorted(set(local_idxs) - set(self.fetched))
        if not idxs:
            return
        sel = torch.as_tensor(idxs, dtype=torch.long, device=self.traj.pos.device)
        sub = [x.index_select(1, sel).cpu().numpy() for x in self.traj]
        eye_n, eye_e = (np.eye(k, dtype=np.float32) for k in self.num_classes)
        for i, tr in zip(idxs, split_trajectories(sub, self.counts[idxs])):
            self.fetched[i] = {"node": eye_n[tr["node"]], "pos": tr["pos"],
                               "halfedge": eye_e[tr["halfedge"]]}
