"""Per-molecule metric families + validity/connectivity + ring analysis.

First-party analogue of `reference/utils/evaluation.py`:
  drug_chem    qed / sa / logp / lipinski                (:12-22)
  count_prop   atoms / bonds / rings / ...               (:24-37)
  frags_counts element & bond-type & ring-size counts    (:52-83)
  ring_topo    ring topology stats                       (:96-110)
  validity     (complete+disconnect)/all; connectivity   (:333-366)
  RingAnalyzer top-k frequent ring types                 (:369-396)

Parallel evaluation uses multiprocessing like the reference Pool(102).
"""
from __future__ import annotations

from collections import Counter
from multiprocessing import Pool
from typing import Dict, List, Sequence

from ..chem.mol import AROMATIC, Mol, MolError
from ..chem.sanitize import reconstruct_from_generated
from .descriptors import all_descriptors
from .sa_score import sa_score


# -- per-mol metric families -------------------------------------------------

def drug_chem(mol: Mol) -> Dict[str, float]:
    d = all_descriptors(mol)
    return {
        "qed": d["qed"],
        "sa": sa_score(mol),
        "logp": d["logp"],
        "lipinski": d["lipinski"],
    }


def count_prop(mol: Mol) -> Dict[str, float]:
    d = all_descriptors(mol)
    return {
        "n_atoms": mol.num_atoms,
        "n_bonds": mol.num_bonds,
        "n_rings": d["n_rings"],
        "n_rotatable": d["rotb"],
        "weight": d["mw"],
        "n_hacc": d["hba"],
        "n_hdon": d["hbd"],
    }


def frags_counts(mol: Mol) -> Dict[str, int]:
    """Element / bond-type / ring-size counts (reference :52-83)."""
    out: Dict[str, int] = {}
    for a in mol.atoms:
        out[f"elem_{a.symbol}"] = out.get(f"elem_{a.symbol}", 0) + 1
    names = {1: "single", 2: "double", 3: "triple", AROMATIC: "aromatic"}
    for b in mol.bonds:
        key = f"bond_{names[b.order]}"
        out[key] = out.get(key, 0) + 1
    for ring in mol.ring_info():
        k = min(len(ring), 9)
        out[f"ring_size_{k}"] = out.get(f"ring_size_{k}", 0) + 1
    return out


def groups_counts(mol: Mol) -> Dict[str, int]:
    """The reference's 21 fr_* functional-group counts (utils/evaluation.py
    :86-94), via the first-party SMARTS engine (eval/fragments.py)."""
    from .fragments import groups_counts as _fr

    return _fr(mol)


def ring_topo(mol: Mol) -> Dict[str, float]:
    rings = mol.ring_info()
    ring_atoms = {a for r in rings for a in r}
    fused = 0
    for r1 in range(len(rings)):
        for r2 in range(r1 + 1, len(rings)):
            if len(set(rings[r1]) & set(rings[r2])) >= 2:
                fused += 1
    arom = 0
    for ring in rings:
        k = len(ring)
        if all(
            (b := mol.bond_between(ring[t], ring[(t + 1) % k])) is not None
            and b.order == AROMATIC
            for t in range(k)
        ):
            arom += 1
    return {
        "n_rings": len(rings),
        "n_ring_atoms": len(ring_atoms),
        "n_fused_pairs": fused,
        "n_aromatic_rings": arom,
    }


def _global_3d(mol: Mol) -> Dict[str, float]:
    from .rmsd import global_3d

    return global_3d(mol)


_METRIC_FNS = {
    "drug_chem": drug_chem,
    "count_prop": count_prop,
    "frags_counts": frags_counts,
    "groups_counts": groups_counts,
    "ring_topo": ring_topo,
    "global_3d": _global_3d,
}


def _apply_metric(args):
    mol, name = args
    try:
        return _METRIC_FNS[name](mol)
    except Exception:
        return {}


def get_metric(mols: Sequence[Mol], metric: str, parallel: bool = False,
               n_workers: int = 8) -> List[Dict]:
    """Per-mol metric dicts (reference get_metric, :134-153)."""
    if metric not in _METRIC_FNS:
        raise ValueError(f"unknown metric family {metric}")
    if parallel and len(mols) > 32:
        with Pool(n_workers) as pool:
            return pool.map(_apply_metric, [(m, metric) for m in mols])
    return [_apply_metric((m, metric)) for m in mols]


# -- validity ----------------------------------------------------------------

def calculate_validity(decoded_list: Sequence[dict],
                       sanitize_mode: str = "reference") -> Dict[str, float]:
    """From decoded generator outputs: validity = (ok + disconnect) / all,
    connectivity = ok / (ok + disconnect) (reference :333-366).

    ``sanitize_mode`` must match the acceptance the pool was generated
    under, or validity.json silently disagrees with the run's summary.json
    in the same evidence file (round-4 advisor finding)."""
    n_ok = n_disc = n_bad = 0
    for decoded in decoded_list:
        try:
            mol = reconstruct_from_generated(
                decoded["element"], decoded["atom_pos"],
                decoded.get("bond_index"), decoded.get("bond_type"),
                mode=sanitize_mode,
            )
            if mol.is_connected():
                n_ok += 1
            else:
                n_disc += 1
        except MolError:
            n_bad += 1
    total = max(n_ok + n_disc + n_bad, 1)
    return {
        "validity": (n_ok + n_disc) / total,
        "connectivity": n_ok / max(n_ok + n_disc, 1),
        "success": n_ok / total,
        "n_complete": n_ok,
        "n_disconnect": n_disc,
        "n_invalid": n_bad,
    }


# -- ring type analysis ------------------------------------------------------

def ring_signature(mol: Mol, ring: List[int]) -> str:
    """Canonical string for a ring's atom/bond sequence (rotation/reflection
    invariant) — the analogue of the reference's ring-fragment SMILES keys."""
    k = len(ring)
    seqs = []
    for direction in (1, -1):
        for start in range(k):
            toks = []
            for t in range(k):
                a = ring[(start + direction * t) % k]
                b = mol.bond_between(a, ring[(start + direction * (t + 1)) % k])
                sym = mol.atoms[a].symbol
                if mol.atoms[a].aromatic:
                    sym = sym.lower()
                toks.append(f"{sym}{b.order}")
            seqs.append("".join(toks))
    return min(seqs)


class RingAnalyzer:
    """Top-k frequent ring types (reference RingAnalyzer, :369-396)."""

    def get_freq_rings(self, mols: Sequence[Mol], topk: int = 10):
        counts: Counter = Counter()
        for mol in mols:
            for ring in mol.ring_info():
                counts[ring_signature(mol, ring)] += 1
        common = counts.most_common(topk)
        return [c[0] for c in common], [c[1] for c in common]
