"""Distance-based bond perception (positions -> bonds).

First-party analogue of the reference's EDM bond-table path
(`reference/utils/edm_bond.py`: empirical per-pair length tables with
10/5/3 pm margins) and the OpenBabel connect-the-dots fallback
(`utils/reconstruct.py:392-451`). Instead of hard-coded pair tables, expected
bond lengths derive from covalent radii by order (r_i(o) + r_j(o),
Cordero/Pyykko values in chem/periodic.py) with order-dependent tolerances —
the same principle, derived from public reference data rather than the
reference's table dump.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .mol import Mol
from .periodic import COVALENT_RADIUS, allowed_valences

# tolerance (Angstrom) per bond order, mirroring the reference's shrinking
# margins for higher orders (10/5/3 pm there; wider here because radii-sum
# predictions are less specific than per-pair empirical tables)
_TOL = {1: 0.45, 2: 0.11, 3: 0.08}


def expected_length(zi: int, zj: int, order: int) -> Optional[float]:
    ri = COVALENT_RADIUS.get(zi, {}).get(order)
    rj = COVALENT_RADIUS.get(zj, {}).get(order)
    if ri is None or rj is None:
        return None
    return ri + rj


def get_bond_order(zi: int, zj: int, dist: float) -> int:
    """0 = no bond, else 1/2/3. Checks triple, then double, then single
    (reference get_bond_order, utils/edm_bond.py:107-132)."""
    for order in (3, 2, 1):
        exp = expected_length(zi, zj, order)
        if exp is not None and dist < exp + _TOL[order]:
            if order == 1:
                return 1
            # higher orders need the distance to be *below* the single-bond
            # expectation too, otherwise long contacts read as multiple bonds
            exp1 = expected_length(zi, zj, 1)
            if exp1 is None or dist < exp1 - 0.05:
                return order
    return 0


def predict_bonds(element: np.ndarray, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs distance scan -> (bond_index [2, n_bonds], bond_type
    [n_bonds]) with each bond once (i < j). O(N^2) like the reference
    (utils/edm_bond.py:155-170)."""
    n = len(element)
    idx: List[Tuple[int, int]] = []
    typ: List[int] = []
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.linalg.norm(pos[i] - pos[j]))
            o = get_bond_order(int(element[i]), int(element[j]), d)
            if o > 0:
                idx.append((i, j))
                typ.append(o)
    if not idx:
        return np.zeros((2, 0), dtype=np.int64), np.zeros((0,), dtype=np.int64)
    return np.array(idx, dtype=np.int64).T, np.array(typ, dtype=np.int64)


def prune_excess_bonds(mol: Mol) -> Mol:
    """Drop the longest bonds at over-valent atoms until valences are legal
    (the reference's openbabel path relies on OB doing this; here explicit)."""
    mol = mol.copy()
    changed = True
    while changed:
        changed = False
        for i, a in enumerate(mol.atoms):
            vmax_list = allowed_valences(a.z, a.charge)
            if not vmax_list:
                continue
            vmax = max(vmax_list)
            while mol.valence_sum(i) > vmax and mol.degree(i) > 1:
                # remove the longest incident bond
                worst, worst_d = None, -1.0
                for j, bidx in mol._adj[i].items():
                    if mol.atoms[i].pos is None or mol.atoms[j].pos is None:
                        continue
                    d = float(np.linalg.norm(mol.atoms[i].pos - mol.atoms[j].pos))
                    if d > worst_d:
                        worst, worst_d = bidx, d
                if worst is None:
                    break
                b = mol.bonds[worst]
                del mol._adj[b.i][b.j]
                del mol._adj[b.j][b.i]
                # tombstone: rebuild bond list at the end
                mol.bonds[worst] = None  # type: ignore
                changed = True
        if changed:
            # compact the bond list and re-index adjacency
            new_bonds = [b for b in mol.bonds if b is not None]
            mol.bonds = []
            for i in mol._adj:
                mol._adj[i] = {}
            for b in new_bonds:
                mol.bonds.append(b)
                k = len(mol.bonds) - 1
                mol._adj[b.i][b.j] = k
                mol._adj[b.j][b.i] = k
    return mol


def mol_from_positions(element: np.ndarray, pos: np.ndarray) -> Mol:
    """positions-only reconstruction: perceive bonds from distances, prune
    over-valences (the `add_edge` alternative path in reference
    utils/reconstruct.py:204-212)."""
    bi, bt = predict_bonds(element, pos)
    m = Mol.from_arrays(element, pos, bi, bt)
    return prune_excess_bonds(m)


# -- connect-the-dots + geometric bond-order perception ----------------------
#
# First-party analogue of the reference's OpenBabel fallback
# (utils/reconstruct.py:392-451): ob.connect_the_dots joins every pair
# within covalent-radius sum + 0.45 A as single bonds, PerceiveBondOrders
# assigns orders from geometry (lengths + ring planarity), and a
# majority-aromatic pass promotes whole 5/6-rings. OpenBabel itself is not
# in the image (and is an optional import in the reference too), so the
# same three stages are implemented on first-party primitives.

_CTD_BUFFER = 0.45          # OB connect_the_dots covalent buffer
_AROM_RING_MAX_DEV = 0.12   # max out-of-plane deviation (A) for a flat ring
_AROM_Z = {6, 7, 8, 16}


def _ring_planarity(pos: np.ndarray) -> float:
    """Max distance of ring atoms from their best-fit plane."""
    c = pos - pos.mean(axis=0)
    # smallest principal axis = plane normal
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    return float(np.abs(c @ vt[-1]).max())


def _aromatic_length_ok(zi: int, zj: int, d: float) -> bool:
    """Is d in the aromatic band for this pair: between the double- and
    single-bond expectations (with slack)?"""
    e1 = expected_length(zi, zj, 1)
    e2 = expected_length(zi, zj, 2)
    if e1 is None:
        return False
    lo = (e2 - 0.06) if e2 is not None else (e1 - 0.22)
    return lo <= d <= e1 - 0.015


def mol_from_positions_ctd(element: np.ndarray, pos: np.ndarray) -> Mol:
    """Connect-the-dots reconstruction with geometric order perception:

    1. join every pair with d < r_i(1) + r_j(1) + 0.45 as a single bond,
       then drop the longest bonds at over-valent atoms (OB's internal
       valence cleanup, explicit here);
    2. promote flat 5/6-rings whose bonds sit in the aromatic length band
       to AROMATIC (PerceiveBondOrders' ring stage + the reference's
       majority-aromatic promotion collapsed into one geometric test);
    3. upgrade remaining non-ring bonds to double/triple where the distance
       demands it (PerceiveBondOrders' acyclic stage), re-checking valence
       legality per upgrade.
    """
    n = len(element)
    idx: List[Tuple[int, int]] = []
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.linalg.norm(pos[i] - pos[j]))
            e1 = expected_length(int(element[i]), int(element[j]), 1)
            if e1 is not None and d < e1 + _CTD_BUFFER:
                idx.append((i, j))
    if idx:
        bi = np.array(idx, dtype=np.int64).T
        bt = np.ones(len(idx), dtype=np.int64)
    else:
        bi = np.zeros((2, 0), dtype=np.int64)
        bt = np.zeros((0,), dtype=np.int64)
    m = prune_excess_bonds(Mol.from_arrays(element, pos, bi, bt))

    # stage 2: aromatic ring promotion
    from .mol import AROMATIC

    for ring in m.ring_info():
        k = len(ring)
        if not 5 <= k <= 6:
            continue
        if any(m.atoms[a].z not in _AROM_Z for a in ring):
            continue
        ring_pos = np.stack([m.atoms[a].pos for a in ring])
        if _ring_planarity(ring_pos) > _AROM_RING_MAX_DEV:
            continue
        bonds = []
        ok = True
        for t in range(k):
            a, b = ring[t], ring[(t + 1) % k]
            bond = m.bond_between(a, b)
            if bond is None:
                ok = False
                break
            d = float(np.linalg.norm(m.atoms[a].pos - m.atoms[b].pos))
            if not _aromatic_length_ok(m.atoms[a].z, m.atoms[b].z, d):
                ok = False
                break
            bonds.append(bond)
        if ok:
            for bond in bonds:
                bond.order = AROMATIC

    # stage 3: acyclic multiple-bond perception
    ring_bonds = m.ring_bond_ids()
    for bidx, bond in enumerate(m.bonds):
        if bidx in ring_bonds or bond.order == AROMATIC:
            continue
        zi, zj = m.atoms[bond.i].z, m.atoms[bond.j].z
        d = float(np.linalg.norm(m.atoms[bond.i].pos - m.atoms[bond.j].pos))
        o = get_bond_order(zi, zj, d)
        if o > 1:
            # only upgrade when both endpoints stay within legal valence
            extra = o - bond.order
            vi = m.valence_sum(bond.i) + extra
            vj = m.valence_sum(bond.j) + extra
            vmax_i = max(allowed_valences(zi, m.atoms[bond.i].charge) or [0])
            vmax_j = max(allowed_valences(zj, m.atoms[bond.j].charge) or [0])
            if vi <= vmax_i and vj <= vmax_j:
                bond.order = o
    return m
