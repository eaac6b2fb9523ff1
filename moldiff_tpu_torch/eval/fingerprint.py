"""Morgan (ECFP-style) circular fingerprints + Tanimoto similarity.

First-party replacement for RDKit's RDKFingerprint / Morgan fingerprints
used by the reference for novelty/uniqueness/diversity/similarity metrics
(`reference/utils/scoring_func.py:115-220`, `utils/similarity.py`).
Standard ECFP construction: per-atom initial invariants, iterative
neighborhood hashing to `radius`, fragment identifiers collected across
iterations, folded into a bit vector.

Identifiers are framework-canonical (not RDKit-bit-compatible); all
similarity metrics are *relative* comparisons within the framework, which is
what the reference metrics compute.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Dict, FrozenSet, List, Set, Tuple

import numpy as np

from ..chem.mol import Mol
from ..chem.sanitize import perceive_aromaticity


def _hash_tuple(t: Tuple) -> int:
    h = hashlib.blake2b(repr(t).encode(), digest_size=8).digest()
    return struct.unpack("<Q", h)[0]


def morgan_fragments(mol: Mol, radius: int = 2) -> Dict[int, int]:
    """fragment identifier -> count over all atoms and radii 0..radius.

    The count dict is what the SA scorer consumes; fold to bits with
    ``fold_fingerprint``.
    """
    perceive_aromaticity(mol)
    n = mol.num_atoms
    invariants = []
    for i in range(n):
        a = mol.atoms[i]
        invariants.append(_hash_tuple((
            a.z, a.charge, mol.degree(i), mol.implicit_h(i),
            int(a.aromatic), int(round(mol.valence_sum(i) * 2)),
        )))

    frags: Dict[int, int] = {}
    seen_envs: Dict[Tuple[int, FrozenSet[int]], bool] = {}

    # radius-0 identifiers
    env_atoms: List[Set[int]] = [{i} for i in range(n)]
    for i in range(n):
        key = (invariants[i], frozenset({i}))
        if key not in seen_envs:
            seen_envs[key] = True
        frags[invariants[i]] = frags.get(invariants[i], 0) + 1

    current = list(invariants)
    for _ in range(radius):
        new = [0] * n
        new_envs: List[Set[int]] = [set() for _ in range(n)]
        for i in range(n):
            nb = sorted(
                (mol.bonds[mol._adj[i][j]].order, current[j])
                for j in mol._adj[i]
            )
            new[i] = _hash_tuple((current[i],) + tuple(nb))
            env = set(env_atoms[i])
            for j in mol._adj[i]:
                env |= env_atoms[j]
            new_envs[i] = env
        current = new
        env_atoms = new_envs
        for i in range(n):
            key = (current[i], frozenset(env_atoms[i]))
            if key in seen_envs:
                continue
            seen_envs[key] = True
            frags[current[i]] = frags.get(current[i], 0) + 1
    return frags


def fold_fingerprint(frags: Dict[int, int], n_bits: int = 2048) -> np.ndarray:
    fp = np.zeros(n_bits, dtype=bool)
    for ident in frags:
        fp[ident % n_bits] = True
    return fp


def morgan_fingerprint(mol: Mol, radius: int = 2, n_bits: int = 2048) -> np.ndarray:
    return fold_fingerprint(morgan_fragments(mol, radius), n_bits)


def tanimoto(fp1: np.ndarray, fp2: np.ndarray) -> float:
    """Tanimoto similarity of two boolean fingerprints (reference
    utils/similarity.py:5-20)."""
    inter = np.count_nonzero(fp1 & fp2)
    union = np.count_nonzero(fp1 | fp2)
    return inter / union if union else 0.0


def bulk_tanimoto(fp: np.ndarray, fps: np.ndarray) -> np.ndarray:
    """fp [B], fps [N, B] -> [N] similarities (vectorized)."""
    inter = np.count_nonzero(fps & fp[None, :], axis=1)
    union = np.count_nonzero(fps | fp[None, :], axis=1)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def pairwise_diversity(fps: np.ndarray) -> float:
    """1 - mean pairwise Tanimoto (reference utils/scoring_func.py:210-220)."""
    n = len(fps)
    if n < 2:
        return 0.0
    sims = []
    for i in range(n):
        s = bulk_tanimoto(fps[i], fps[i + 1:])
        sims.append(s)
    return float(1.0 - np.mean(np.concatenate(sims)))
