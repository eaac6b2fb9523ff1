"""Minimal molecule graph: atoms, bonds, rings, components.

First-party replacement for the slice of RDKit's RWMol/Mol that the
reference uses in reconstruction and evaluation
(`reference/utils/reconstruct.py`, `utils/evaluation.py`): mutable
atom/bond graph, ring perception (smallest-set-of-smallest-rings style via a
cycle basis), connected components, implicit-H bookkeeping.

Bond orders: 1, 2, 3, and AROMATIC (represented as order 4 to match the
model's bond classes; contributes 1.5 to valence sums).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .periodic import ATOMIC_MASS, ELEMENTS, allowed_valences

AROMATIC = 4
BOND_ORDER_VALUE = {1: 1.0, 2: 2.0, 3: 3.0, AROMATIC: 1.5}


class MolError(Exception):
    """Raised on malformed molecular graphs (analogue of the reference's
    MolReconsError, utils/reconstruct.py:23)."""


@dataclass
class Atom:
    z: int                     # atomic number
    charge: int = 0
    pos: Optional[np.ndarray] = None
    # explicit H count override; None = fill implicit Hs to default valence
    num_explicit_h: Optional[int] = None
    aromatic: bool = False

    @property
    def symbol(self) -> str:
        return ELEMENTS.get(self.z, f"[{self.z}]")


@dataclass
class Bond:
    i: int
    j: int
    order: int  # 1 | 2 | 3 | AROMATIC

    def other(self, k: int) -> int:
        return self.j if k == self.i else self.i


class Mol:
    """Mutable molecular graph with 0-based atom indices."""

    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: Dict[int, Dict[int, int]] = {}  # i -> {j: bond_idx}

    # -- construction --------------------------------------------------------

    def add_atom(self, z: int, charge: int = 0, pos=None) -> int:
        self.atoms.append(
            Atom(int(z), int(charge),
                 np.asarray(pos, dtype=np.float64) if pos is not None else None)
        )
        idx = len(self.atoms) - 1
        self._adj[idx] = {}
        return idx

    def add_bond(self, i: int, j: int, order: int) -> int:
        if i == j:
            raise MolError(f"self-bond at atom {i}")
        if j in self._adj[i]:
            raise MolError(f"duplicate bond {i}-{j}")
        if order not in BOND_ORDER_VALUE:
            raise MolError(f"bad bond order {order}")
        self.bonds.append(Bond(i, j, int(order)))
        b = len(self.bonds) - 1
        self._adj[i][j] = b
        self._adj[j][i] = b
        return b

    @classmethod
    def from_arrays(cls, element, pos=None, bond_index=None, bond_type=None) -> "Mol":
        """Build from the generator's output arrays (analogue of the RWMol
        build in reference utils/reconstruct.py:218-243). ``bond_index`` may
        contain each bond once or in both directions; duplicates collapse."""
        m = cls()
        for a in range(len(element)):
            m.add_atom(int(element[a]), pos=pos[a] if pos is not None else None)
        if bond_index is not None and np.size(bond_index):
            seen = set()
            for (i, j), t in zip(np.asarray(bond_index).T, np.asarray(bond_type)):
                i, j = int(i), int(j)
                if i == j:
                    raise MolError(f"self-bond at atom {i}")
                key = (min(i, j), max(i, j))
                if key in seen:
                    continue
                seen.add(key)
                if not (0 <= i < m.num_atoms and 0 <= j < m.num_atoms):
                    raise MolError(f"bond index out of range: {i}-{j}")
                m.add_bond(i, j, int(t))
        return m

    def copy(self) -> "Mol":
        m = Mol()
        for a in self.atoms:
            m.atoms.append(Atom(a.z, a.charge,
                                None if a.pos is None else a.pos.copy(),
                                a.num_explicit_h, a.aromatic))
            m._adj[len(m.atoms) - 1] = {}
        for b in self.bonds:
            m.bonds.append(Bond(b.i, b.j, b.order))
            idx = len(m.bonds) - 1
            m._adj[b.i][b.j] = idx
            m._adj[b.j][b.i] = idx
        return m

    # -- queries -------------------------------------------------------------

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def neighbors(self, i: int) -> List[int]:
        return list(self._adj[i].keys())

    def bond_between(self, i: int, j: int) -> Optional[Bond]:
        b = self._adj[i].get(j)
        return self.bonds[b] if b is not None else None

    def degree(self, i: int) -> int:
        return len(self._adj[i])

    def valence_sum(self, i: int, aromatic_as: float = 1.5) -> float:
        """Sum of bond orders at atom i (aromatic bonds count aromatic_as)."""
        total = 0.0
        for j, b in self._adj[i].items():
            o = self.bonds[b].order
            total += aromatic_as if o == AROMATIC else float(o)
        return total

    def implicit_h(self, i: int) -> int:
        """Implicit hydrogens filling up to the smallest allowed valence.

        Aromatic contributions are rounded per RDKit convention: an aromatic
        atom with two aromatic bonds has valence contribution 3 (1.5*2).
        """
        a = self.atoms[i]
        if a.num_explicit_h is not None:
            return a.num_explicit_h
        if a.aromatic and a.z in (8, 16) and self.degree(i) == 2:
            # divalent aromatic heteroatoms (furan O, thiophene S): the
            # kekulized valence is 2 and they carry no H; the 1.5-per-
            # aromatic-bond sum would round up to 3 and give S a spurious H
            return 0
        v = self.valence_sum(i)
        v_int = int(np.ceil(v - 1e-9))
        for allowed in allowed_valences(a.z, a.charge):
            if v_int <= allowed:
                return allowed - v_int
        return 0

    def molecular_weight(self) -> float:
        mw = 0.0
        for i, a in enumerate(self.atoms):
            mw += ATOMIC_MASS.get(a.z, 0.0)
            mw += self.implicit_h(i) * ATOMIC_MASS[1]
        return mw

    # -- connectivity --------------------------------------------------------

    def connected_components(self) -> List[List[int]]:
        seen: Set[int] = set()
        comps = []
        for s in range(self.num_atoms):
            if s in seen:
                continue
            stack, comp = [s], []
            seen.add(s)
            while stack:
                u = stack.pop()
                comp.append(u)
                for v in self._adj[u]:
                    if v not in seen:
                        seen.add(v)
                        stack.append(v)
            comps.append(sorted(comp))
        return comps

    def is_connected(self) -> bool:
        return self.num_atoms == 0 or len(self.connected_components()) == 1

    # -- rings ---------------------------------------------------------------

    def ring_info(self) -> List[List[int]]:
        """SSSR-style ring perception: cycle basis of each biconnected
        component, preferring smallest rings. Adequate for drug-like
        molecules (reference uses RDKit GetRingInfo)."""
        return _sssr(self)

    def ring_bond_ids(self) -> Set[int]:
        rb: Set[int] = set()
        for ring in self.ring_info():
            k = len(ring)
            for t in range(k):
                b = self._adj[ring[t]].get(ring[(t + 1) % k])
                if b is not None:
                    rb.add(b)
        return rb

    def atoms_in_rings(self) -> Set[int]:
        return {a for ring in self.ring_info() for a in ring}


def _sssr(mol: Mol) -> List[List[int]]:
    """Smallest set of smallest rings via iterative shortest-cycle extraction.

    For each bond, find the shortest cycle through it (BFS on the graph with
    that bond removed); collect cycles until the cyclomatic number
    E - V + C is covered, preferring shorter cycles.
    """
    n = mol.num_atoms
    if n == 0:
        return []
    num_comp = len(mol.connected_components())
    target = mol.num_bonds - n + num_comp
    if target <= 0:
        return []

    candidates: List[Tuple[int, frozenset, List[int]]] = []
    for b_idx, bond in enumerate(mol.bonds):
        path = _shortest_path_without_bond(mol, bond.i, bond.j, b_idx)
        if path is not None:
            ring = path  # path j..i plus the bond closes the cycle
            candidates.append((len(ring), frozenset(ring), ring))
    candidates.sort(key=lambda t: t[0])

    chosen: List[List[int]] = []
    chosen_sets: List[frozenset] = []
    covered_bonds: Set[int] = set()
    for _, rset, ring in candidates:
        if len(chosen) >= target:
            break
        if rset in chosen_sets:
            continue
        ring_bonds = set()
        k = len(ring)
        for t in range(k):
            ring_bonds.add(mol._adj[ring[t]][ring[(t + 1) % k]])
        if ring_bonds <= covered_bonds:
            continue
        chosen.append(ring)
        chosen_sets.append(rset)
        covered_bonds |= ring_bonds
    return chosen


def _shortest_path_without_bond(mol: Mol, src: int, dst: int, skip_bond: int):
    """BFS shortest path src -> dst avoiding skip_bond; returns the cycle
    atom list [src, ..., dst] or None."""
    from collections import deque

    prev = {src: -1}
    q = deque([src])
    while q:
        u = q.popleft()
        if u == dst:
            break
        for v, b in mol._adj[u].items():
            if b == skip_bond or v in prev:
                continue
            prev[v] = u
            q.append(v)
    if dst not in prev:
        return None
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    return path
