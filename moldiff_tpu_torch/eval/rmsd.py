"""Rigid-alignment RMSD (Kabsch) and the global-3D quality metric.

First-party analogue of the reference's `get_rdkit_rmsd`
(`reference/utils/scoring_func.py:56-74`): the reference embeds 100
ETKDG conformers with RDKit + UFF and reports the best heavy-atom RMSD to
the generated geometry. Here the conformers come from the first-party
distance-geometry embedder (chem/embed.py: bounds matrix from bond-length
tables + idealized angles + torsion ranges, triangle smoothing, metric-
matrix embedding, bounds refinement) with the same best-of-100 protocol.
No torsion-knowledge terms and no symmetry-aware GetBestRMS atom matching
(documented divergences), so absolute values run higher than RDKit's; the
metric remains a consistent relative measure across compared methods.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..chem.mol import Mol


def kabsch_rmsd(p: np.ndarray, q: np.ndarray, center: bool = True) -> float:
    """Minimum RMSD between point sets p, q [n, 3] over rotations (and
    optional translation)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    assert p.shape == q.shape
    if center:
        p = p - p.mean(axis=0)
        q = q - q.mean(axis=0)
    h = p.T @ q
    u, s, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    diag = np.diag([1.0, 1.0, d])
    r = vt.T @ diag @ u.T
    p_rot = p @ r.T
    return float(np.sqrt(np.mean(np.sum((p_rot - q) ** 2, axis=1))))


def best_embedding_rmsd(
    mol: Mol, n_conformers: int = 100, seed: int = 0
) -> Optional[float]:
    """Best heavy-atom RMSD between mol's coordinates and ``n_conformers``
    distance-geometry re-embeddings (reference protocol: best of 100 ETKDG
    conformers, scoring_func.py:56-74)."""
    from ..chem.embed import generate_conformers

    if mol.num_atoms < 2 or any(a.pos is None for a in mol.atoms):
        return None
    ref_pos = np.stack([a.pos for a in mol.atoms])
    best = None
    for conf in generate_conformers(mol, n_conformers, seed=seed):
        r = kabsch_rmsd(ref_pos, conf)
        best = r if best is None else min(best, r)
    return best


def global_3d(mol: Mol) -> dict:
    """Metric-family dict (reference global_3d, utils/evaluation.py:40-49)."""
    r = best_embedding_rmsd(mol)
    return {"rmsd_embed": r if r is not None else float("nan")}
