"""Molecular descriptors: MW, HBA/HBD, TPSA, rotatable bonds, logP, QED,
Lipinski.

First-party replacements for the RDKit descriptor calls in the reference
(`reference/utils/scoring_func.py:28-87`). Exact where the descriptor
is graph-defined (MW, HBA, HBD, ROTB, rings); principled approximations
where RDKit relies on large SMARTS tables:

  * TPSA — Ertl 2000 fragment contributions for the common N/O environments
    (S/P excluded, matching RDKit's default).
  * logP — coarse Wildman & Crippen 1999 atom typing (element + aromaticity
    + heteroatom attachment classes, not the full 68-type SMARTS table).
  * QED — Bickerton 2012 ADS functions and weights as reproduced in the
    open-source implementations; the ALERTS descriptor defaults to 0 (no
    SMARTS alert library), a constant shift applied uniformly to all
    compared methods.
"""
from __future__ import annotations

import math
from typing import Dict, List

from ..chem.mol import AROMATIC, Mol
from ..chem.sanitize import perceive_aromaticity


# ---------------------------------------------------------------------------
# H-bond donors / acceptors, rotatable bonds, rings
# ---------------------------------------------------------------------------

def num_hbd(mol: Mol) -> int:
    """N-H / O-H counts (Lipinski donor definition)."""
    total = 0
    for i, a in enumerate(mol.atoms):
        if a.z in (7, 8):
            total += _h_count(mol, i)
    return total


def num_hba(mol: Mol) -> int:
    """N and O atoms (Lipinski acceptor definition)."""
    return sum(1 for a in mol.atoms if a.z in (7, 8))


def _h_count(mol: Mol, i: int) -> int:
    """Hydrogen count; aromatic N uses the kekulized structure to decide
    pyrrole-type [nH]."""
    return mol.implicit_h(i)


def num_rotatable_bonds(mol: Mol) -> int:
    """Single non-ring bonds between two non-terminal heavy atoms (strict
    RDKit definition minus amide exclusion)."""
    ring_bonds = mol.ring_bond_ids()
    count = 0
    for idx, b in enumerate(mol.bonds):
        if b.order != 1 or idx in ring_bonds:
            continue
        if mol.degree(b.i) < 2 or mol.degree(b.j) < 2:
            continue
        count += 1
    return count


def num_aromatic_rings(mol: Mol) -> int:
    perceive_aromaticity(mol)
    count = 0
    for ring in mol.ring_info():
        k = len(ring)
        ok = True
        for t in range(k):
            bd = mol.bond_between(ring[t], ring[(t + 1) % k])
            if bd is None or bd.order != AROMATIC:
                ok = False
                break
        count += ok
    return count


def num_rings(mol: Mol) -> int:
    return len(mol.ring_info())


# ---------------------------------------------------------------------------
# TPSA (Ertl 2000, N/O contributions)
# ---------------------------------------------------------------------------

def tpsa(mol: Mol) -> float:
    perceive_aromaticity(mol)
    total = 0.0
    for i, a in enumerate(mol.atoms):
        if a.z == 7:
            total += _tpsa_n(mol, i)
        elif a.z == 8:
            total += _tpsa_o(mol, i)
    return total


def _bond_orders(mol: Mol, i: int) -> List[int]:
    return sorted(mol.bonds[b].order for b in mol._adj[i].values())


def _tpsa_n(mol: Mol, i: int) -> float:
    a = mol.atoms[i]
    h = _h_count(mol, i)
    orders = _bond_orders(mol, i)
    narom = orders.count(AROMATIC)
    if a.charge == 0:
        if narom >= 2:
            # aromatic nitrogen
            if h > 0:
                return 15.79
            if len(orders) == 3:
                return 4.93  # substituted aromatic n
            return 12.89
        if 3 in orders:
            return 23.79  # nitrile N
        if 2 in orders:
            if h == 0 and len(orders) == 2:
                return 12.36  # =N- imine
            if h == 1 and len(orders) == 1:
                return 23.85  # =NH
            return 12.36
        # single bonds only
        if h == 0:
            return 3.24
        if h == 1:
            return 12.03
        return 26.02
    if a.charge == 1:
        if narom >= 2:
            return 14.14 if h else 4.10
        if h == 0:
            return 0.00
        if h == 1:
            return 4.44
        if h == 2:
            return 16.61
        return 27.64
    return 0.0


def _tpsa_o(mol: Mol, i: int) -> float:
    a = mol.atoms[i]
    h = _h_count(mol, i)
    orders = _bond_orders(mol, i)
    narom = orders.count(AROMATIC)
    if a.charge == 0:
        if narom >= 2:
            return 13.14  # aromatic o
        if 2 in orders:
            return 17.07  # =O
        if h >= 1:
            return 20.23  # -OH
        return 9.23      # ether
    if a.charge == -1:
        return 23.06
    return 0.0


# ---------------------------------------------------------------------------
# logP (full Wildman-Crippen 68-type table, eval/crippen.py)
# ---------------------------------------------------------------------------

def crippen_logp(mol: Mol) -> float:
    """Wildman & Crippen 1999 logP with the full published SMARTS atom-type
    table (eval/crippen.py; golden-tested against RDKit MolLogP values)."""
    from .crippen import logp

    return logp(mol)


# ---------------------------------------------------------------------------
# QED (Bickerton et al. 2012)
# ---------------------------------------------------------------------------

# ADS parameters (a, b, c, d, e, f, dmax) per descriptor, from the paper SI
# as reproduced in open-source implementations.
_ADS = {
    "MW": (2.817065973, 392.5754953, 290.7489764, 2.419764353,
           49.22325677, 65.37051707, 104.9805561),
    "ALOGP": (3.172690585, 137.8624751, 2.534937431, 4.581497897,
              0.822739154, 0.576295591, 131.3186604),
    "HBA": (2.948620388, 160.4605972, 3.615294657, 4.435986202,
            0.290141953, 1.300669958, 148.7763046),
    "HBD": (1.618662227, 1010.051101, 0.985094388, 0.000000001,
            0.713820843, 0.920922555, 258.1632616),
    "PSA": (1.876861559, 125.2232657, 62.90773554, 87.83366614,
            12.01999824, 28.51324732, 104.5686167),
    "ROTB": (0.010000091, 272.4121427, 2.558379970, 1.565547684,
             1.271567166, 2.758063707, 105.4420403),
    "AROM": (3.217788970, 957.7374108, 2.274627939, 0.000000001,
             1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.010000000, 1199.094025, -0.09002593, 0.000000001,
               0.185904477, 0.875193782, 417.7253140),
}
_QED_WEIGHTS = {
    "MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61,
    "PSA": 0.06, "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95,
}


def _ads(x: float, p) -> float:
    a, b, c, d, e, f, dmax = p
    val = a + b / (1 + math.exp(-(x - c + d / 2) / e)) \
        * (1 - 1 / (1 + math.exp(-(x - c - d / 2) / f)))
    return max(val / dmax, 1e-9)


def qed(mol: Mol) -> float:
    from .alerts import num_alerts

    props = {
        "MW": mol.molecular_weight(),
        "ALOGP": crippen_logp(mol),
        "HBA": num_hba(mol),
        "HBD": num_hbd(mol),
        "PSA": tpsa(mol),
        "ROTB": num_rotatable_bonds(mol),
        "AROM": num_aromatic_rings(mol),
        # Brenk-style structural alerts (eval/alerts.py, SMARTS engine)
        "ALERTS": num_alerts(mol),
    }
    num = 0.0
    den = 0.0
    for k, w in _QED_WEIGHTS.items():
        num += w * math.log(_ads(props[k], _ADS[k]))
        den += w
    return math.exp(num / den)


def lipinski(mol: Mol) -> int:
    """Number of Lipinski rule-of-five criteria satisfied (0..5, reference
    utils/scoring_func.py obey/violation counting)."""
    rules = [
        mol.molecular_weight() < 500,
        crippen_logp(mol) <= 5,
        num_hbd(mol) <= 5,
        num_hba(mol) <= 10,
        num_rotatable_bonds(mol) <= 10,
    ]
    return sum(rules)


def all_descriptors(mol: Mol) -> Dict[str, float]:
    return {
        "mw": mol.molecular_weight(),
        "logp": crippen_logp(mol),
        "hba": num_hba(mol),
        "hbd": num_hbd(mol),
        "tpsa": tpsa(mol),
        "rotb": num_rotatable_bonds(mol),
        "n_rings": num_rings(mol),
        "n_aromatic_rings": num_aromatic_rings(mol),
        "qed": qed(mol),
        "lipinski": lipinski(mol),
    }
