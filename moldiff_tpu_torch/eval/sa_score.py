"""Synthetic accessibility (SA) score, Ertl & Schuffenhauer 2009.

First-party analogue of the reference's vendored RDKit-contrib sascorer
(`reference/utils/sascorer.py` + fpscores.pkl.gz). The score is

    SA = fragment_score - complexity_penalty,   rescaled to [1, 10]

The fragment score needs a fragment-frequency table over a large compound
DB; the reference ships RDKit's precomputed `fpscores` keyed by RDKit Morgan
bits, which cannot be reused with a different fingerprint implementation.
Here the table is *buildable from any dataset* (``FragmentScorer.fit`` —
log-decile scoring exactly like Ertl's procedure). A fitted table for the
synthetic training corpus ships with the JAX package
(moldiff_tpu/eval/data/fragment_scores_synthetic.pkl, the analogue of the
reference's fpscores artifact) and loads as the default; refit per dataset
with scripts/build_fragment_scores.py. The port reads that committed file
by its path from the repository root (a dict of ints to floats: loading it
imports nothing) and raises FileNotFoundError without it: an empty table
would score every molecule, silently, as if no fragment were known.
"""
from __future__ import annotations

import math
import os
import pickle
from typing import Dict, Iterable, Optional

from ..chem.mol import Mol
from .fingerprint import morgan_fragments


class FragmentScorer:
    """Fragment commonality table: identifier -> score in [-4, 0.5]."""

    def __init__(self, scores: Optional[Dict[int, float]] = None):
        self.scores = scores or {}

    @classmethod
    def fit(cls, mols: Iterable[Mol], radius: int = 2) -> "FragmentScorer":
        """Ertl's procedure (2009, sec. 'fragment score'): count radius-2
        fragments over the corpus, anchor at the count of the fragment where
        the sorted cumulative occurrence reaches 80% of all occurrences, and
        score each fragment log10(count / anchor), clipped to [-4, 4].
        Fragments common enough to cover the bulk of the corpus score >= 0
        (easy), rare ones negative (hard) — the same shape as the shipped
        RDKit fpscores table."""
        counts: Dict[int, int] = {}
        for mol in mols:
            for ident, c in morgan_fragments(mol, radius).items():
                counts[ident] = counts.get(ident, 0) + c
        if not counts:
            return cls({})
        total = sum(counts.values())
        anchor = None
        cum = 0
        for c in sorted(counts.values(), reverse=True):
            cum += c
            if cum >= 0.8 * total:
                anchor = c
                break
        anchor = max(anchor or 1, 1)
        scores = {
            ident: float(min(4.0, max(-4.0, math.log10(c / anchor))))
            for ident, c in counts.items()
        }
        return cls(scores)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.scores, f)

    @classmethod
    def load(cls, path: str) -> "FragmentScorer":
        with open(path, "rb") as f:
            return cls(pickle.load(f))

    def fragment_score(self, mol: Mol, radius: int = 2) -> float:
        frags = morgan_fragments(mol, radius)
        if not frags:
            return 0.0
        total = 0.0
        nf = 0
        for ident, c in frags.items():
            total += self.scores.get(ident, -4.0 if self.scores else 0.0) * c
            nf += c
        return total / nf


_DEFAULT_SCORER: Optional[FragmentScorer] = None

# shipped table fitted on the synthetic training corpus (the analogue of the
# reference's fpscores.pkl.gz, fitted on PubChem); scripts/
# build_fragment_scores.py refits for any other dataset
_SHIPPED_TABLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "moldiff_tpu", "eval", "data", "fragment_scores_synthetic.pkl")


def _default_scorer() -> FragmentScorer:
    global _DEFAULT_SCORER
    if _DEFAULT_SCORER is None:
        if not os.path.exists(_SHIPPED_TABLE):
            raise FileNotFoundError(
                f"SA fragment table {_SHIPPED_TABLE} is missing; pass a scorer or call "
                "set_default_fragment_scorer")
        _DEFAULT_SCORER = FragmentScorer.load(_SHIPPED_TABLE)
    return _DEFAULT_SCORER


def set_default_fragment_scorer(scorer: FragmentScorer) -> None:
    global _DEFAULT_SCORER
    _DEFAULT_SCORER = scorer


def sa_score(mol: Mol, scorer: Optional[FragmentScorer] = None) -> float:
    """Ertl SA score in [1 (easy), 10 (hard)]."""
    scorer = scorer or _default_scorer()
    n = mol.num_atoms
    if n == 0:
        return 10.0

    frag = scorer.fragment_score(mol)

    rings = mol.ring_info()
    ring_atoms = {a for r in rings for a in r}
    # spiro: atoms shared by >= 2 rings with no shared bond; bridgeheads:
    # atoms in >= 2 rings sharing a bond
    from collections import Counter

    ring_membership = Counter(a for r in rings for a in r)
    n_spiro = 0
    n_bridge = 0
    for a, k in ring_membership.items():
        if k >= 2:
            shared_bond = False
            for r1 in range(len(rings)):
                for r2 in range(r1 + 1, len(rings)):
                    if a in rings[r1] and a in rings[r2]:
                        common = set(rings[r1]) & set(rings[r2])
                        if len(common) >= 2:
                            shared_bond = True
            if shared_bond:
                n_bridge += 1
            else:
                n_spiro += 1

    size_penalty = n ** 1.005 - n
    ring_complexity = math.log10(max(len(ring_atoms), 1)) if ring_atoms else 0.0
    macro_penalty = math.log10(2) if any(len(r) > 8 for r in rings) else 0.0
    bridge_penalty = math.log10(n_bridge + 1)
    spiro_penalty = math.log10(n_spiro + 1)

    score2 = -(size_penalty + ring_complexity + spiro_penalty
               + bridge_penalty + macro_penalty)
    # symmetry bonus for large molecules made of repeated fragments
    frags = morgan_fragments(mol, 2)
    n_unique = len(frags)
    score3 = 0.0
    if n > len(frags):
        score3 = math.log(float(n) / n_unique) * 0.5

    raw = frag + score2 + score3
    # rescale to 1..10 (constants from the published implementation)
    smin, smax = -4.0, 2.5
    sa = 11.0 - (raw - smin + 1.0) / (smax - smin) * 9.0
    if sa > 8.0:
        sa = 8.0 + math.log(sa + 1.0 - 9.0)
    return float(min(max(sa, 1.0), 10.0))
