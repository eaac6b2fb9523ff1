"""Novelty / uniqueness / diversity / reference-set similarity.

First-party analogue of the reference `SimilarityAnalysis`
(`reference/utils/scoring_func.py:102-220`): cached train/val
fingerprints, novelty (fraction with no train-set max-Tanimoto == 1),
uniqueness (unique canonical SMILES fraction), sim_with_train/val
(mean max-Tanimoto), diversity (1 - mean pairwise Tanimoto).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..chem.mol import Mol
from ..chem.smiles import mol_to_smiles
from .fingerprint import bulk_tanimoto, morgan_fingerprint, pairwise_diversity


class SimilarityAnalysis:
    def __init__(
        self,
        train_mols: Optional[Sequence[Mol]] = None,
        val_mols: Optional[Sequence[Mol]] = None,
        cache_path: Optional[str] = None,
        n_bits: int = 2048,
    ):
        self.n_bits = n_bits
        self.train_fps = None
        self.val_fps = None
        self.train_smiles: set = set()
        if cache_path and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                blob = pickle.load(f)
            self.train_fps = blob["train_fps"]
            self.val_fps = blob.get("val_fps")
            self.train_smiles = blob.get("train_smiles", set())
        else:
            if train_mols is not None:
                self.train_fps = self._fps(train_mols)
                self.train_smiles = {mol_to_smiles(m) for m in train_mols}
            if val_mols is not None:
                self.val_fps = self._fps(val_mols)
            if cache_path:
                with open(cache_path, "wb") as f:
                    pickle.dump(
                        {
                            "train_fps": self.train_fps,
                            "val_fps": self.val_fps,
                            "train_smiles": self.train_smiles,
                        },
                        f,
                    )

    def _fps(self, mols: Sequence[Mol]) -> np.ndarray:
        return np.stack([morgan_fingerprint(m, n_bits=self.n_bits) for m in mols])

    # -- metrics -------------------------------------------------------------

    def uniqueness(self, mols: Sequence[Mol]) -> float:
        smiles = [mol_to_smiles(m) for m in mols]
        return len(set(smiles)) / max(len(smiles), 1)

    def novelty(self, mols: Sequence[Mol]) -> float:
        """Fraction of generated canonical SMILES not in the train set."""
        if not self.train_smiles:
            return float("nan")
        smiles = [mol_to_smiles(m) for m in mols]
        novel = sum(1 for s in smiles if s not in self.train_smiles)
        return novel / max(len(smiles), 1)

    def _sim_with(self, mols: Sequence[Mol], ref_fps) -> float:
        if ref_fps is None or len(ref_fps) == 0:
            return float("nan")
        sims = []
        for m in mols:
            fp = morgan_fingerprint(m, n_bits=self.n_bits)
            sims.append(float(np.max(bulk_tanimoto(fp, ref_fps))))
        return float(np.mean(sims))

    def sim_with_train(self, mols: Sequence[Mol]) -> float:
        return self._sim_with(mols, self.train_fps)

    def sim_with_val(self, mols: Sequence[Mol]) -> float:
        return self._sim_with(mols, self.val_fps)

    def diversity(self, mols: Sequence[Mol]) -> float:
        fps = self._fps(mols) if len(mols) else np.zeros((0, self.n_bits), bool)
        return pairwise_diversity(fps)

    def all_metrics(self, mols: Sequence[Mol]) -> Dict[str, float]:
        return {
            "uniqueness": self.uniqueness(mols),
            "novelty": self.novelty(mols),
            "sim_with_train": self.sim_with_train(mols),
            "sim_with_val": self.sim_with_val(mols),
            "diversity": self.diversity(mols),
        }
