"""Host-side sampling pipeline: generate until N molecules
(moldiff_tpu/sample/pipeline.py).

  draw sizes ~ N(24.9, 5.5) -> group by bucket -> per-bucket fixed-size
  batches of the reverse chain -> unpad -> decode -> sanitize cascade ->
  pool {finished, failed}

Failed molecules (reconstruction error or disconnected SMILES) are kept in
the ``failed`` pool, and generation stops once failures exceed
``max_failures_factor`` times the requested count. Classification runs in
this process, one molecule after another.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import time

import numpy as np
import torch

from ..chem.mol import MolError
from ..chem.sanitize import reconstruct_from_generated
from ..chem.smiles import mol_to_smiles
from ..data.batching import DEFAULT_BUCKETS, node_mask_from_counts, unpad_arrays
from ..data.featurize import GEOM_DRUG_SIZE_MEAN, GEOM_DRUG_SIZE_STD, MolFeaturizer


class MolSampler:
    """A MolDiff model with the bucketed batching and the decode/classify path."""

    def __init__(self, model, featurizer: MolFeaturizer,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, batch_size: int = 128,
                 size_mean: float = GEOM_DRUG_SIZE_MEAN, size_std: float = GEOM_DRUG_SIZE_STD,
                 sanitize_mode: str = "reference", commit: str = "none"):
        self.model = model
        self.featurizer = featurizer
        self.buckets = tuple(sorted(buckets))
        self.batch_size = batch_size
        self.size_mean = size_mean
        self.size_std = size_std
        self.sanitize_mode = sanitize_mode
        self.commit = commit
        self.chains = 0        # reverse chains run so far
        self.chain_s = 0.0     # wall time of those chains, device work included

    def draw_sizes(self, n_graphs: int, rng: np.random.Generator) -> np.ndarray:
        """Sizes ~ N(mean, std) clipped to [3, largest bucket]."""
        sizes = rng.normal(self.size_mean, self.size_std, size=n_graphs)
        return np.clip(sizes.astype(np.int64), 3, self.buckets[-1])

    def sample_sizes(self, params, sizes: np.ndarray, generator: torch.Generator) -> List[dict]:
        """Reverse chains for molecules of the given sizes -> per-molecule
        decoded dicts (pre-sanitize). Each bucket runs in batches of
        ``batch_size``, padded with throwaway 3-atom graphs."""
        out: List[dict] = [None] * len(sizes)
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
                preds = self.model.sample(params, node_mask, generator, commit=self.commit)
                host = {k: v.float().cpu().numpy() for k, v in preds._asdict().items()}
                self.chain_s += time.perf_counter() - t0
                self.chains += 1
                per_mol = unpad_arrays(host, counts)
                for local_i, global_i in enumerate(chunk):
                    p = per_mol[local_i]
                    out[global_i] = self.featurizer.decode_output(
                        p["pred_node"], p["pred_pos"], p["pred_halfedge"])
        return out

    def generate(self, params, num_mols: int, generator: torch.Generator,
                 rng: Optional[np.random.Generator] = None, max_failures_factor: int = 3,
                 batch_graphs: Optional[int] = None, logger=None) -> Dict[str, list]:
        """Generate until ``num_mols`` molecules are finished. Returns the
        pool {'finished': [...], 'failed': [...]} of classify_decoded
        entries, 'finished' cut to ``num_mols``, and under 'classified' the
        counts of every molecule classified before that cut."""
        rng = rng or np.random.default_rng(0)
        batch_graphs = batch_graphs or self.batch_size
        pool = {"finished": [], "failed": []}
        while len(pool["finished"]) < num_mols:
            if len(pool["failed"]) > max_failures_factor * num_mols:
                if logger:
                    logger("too many failed molecules, aborting")
                break
            decoded = self.sample_sizes(params, self.draw_sizes(batch_graphs, rng), generator)
            for d in decoded:
                entry = classify_decoded(d, sanitize_mode=self.sanitize_mode)
                pool[entry["pool"]].append(entry)
            if logger:
                logger(f"pool: finished {len(pool['finished'])} | failed {len(pool['failed'])}")
        pool["classified"] = {"finished": len(pool["finished"]), "failed": len(pool["failed"])}
        pool["finished"] = pool["finished"][:num_mols]
        return pool


def classify_decoded(decoded: dict, sanitize_mode: str = "reference") -> dict:
    """Decoded dict -> pool entry: sanitize cascade + disconnect check
    (pipeline.py:503-568, model-predicted bonds)."""
    stats: dict = {}
    try:
        mol = reconstruct_from_generated(
            decoded["element"], decoded["atom_pos"], decoded.get("bond_index"),
            decoded.get("bond_type"), mode=sanitize_mode, stats=stats)
    except MolError:
        return {"pool": "failed", "decoded": decoded, "reason": "recon_error"}
    try:
        smiles = mol_to_smiles(mol)
    except Exception:
        return {"pool": "failed", "decoded": decoded, "reason": "smiles_error"}
    if "." in smiles:
        return {"pool": "failed", "decoded": decoded, "reason": "disconnect",
                "mol": mol, "smiles": smiles, "stage": stats.get("stage")}
    return {"pool": "finished", "decoded": decoded, "mol": mol,
            "smiles": smiles, "stage": stats.get("stage")}
