"""Local 3D geometry metrics: bond-length / angle / dihedral distributions.

First-party analogue of the reference `Local3D`
(`reference/utils/evaluation.py:156-313`): the same predefined
frequent GEOM-Drug substructure patterns, matched with a built-in
linear-path SMARTS-subset matcher (aromatic lowercase atoms, `[#n]`
any-aromaticity atoms, aliphatic element symbols; bonds `- = # :`), then
measured on conformer coordinates.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem.mol import AROMATIC, Mol
from ..chem.periodic import SYMBOL_TO_Z
from ..chem.sanitize import perceive_aromaticity

# -- mini SMARTS-subset parser (linear paths only) ---------------------------

_ATOM_RE = re.compile(r"\[#(\d+)\]|Cl|Br|[cnos]|[BCNOFPSI]")
_BOND_CHARS = {"-": 1, "=": 2, "#": 3, ":": AROMATIC}


def parse_path_smarts(s: str) -> Tuple[List[Tuple[Optional[int], Optional[bool]]], List[Optional[int]]]:
    """'c:c-[#6]' -> ([(z, aromatic?), ...], [bond_order_or_None, ...]).

    atom spec: (z, None)=any aromaticity; (z, True)=aromatic; (z, False)=
    aliphatic. bond spec None = single-or-aromatic (SMARTS default).
    """
    atoms: List[Tuple[Optional[int], Optional[bool]]] = []
    bonds: List[Optional[int]] = []
    i = 0
    expect_atom = True
    while i < len(s):
        ch = s[i]
        if expect_atom:
            m = _ATOM_RE.match(s, i)
            if not m:
                raise ValueError(f"bad SMARTS atom at {s[i:]}")
            tok = m.group(0)
            if tok.startswith("[#"):
                atoms.append((int(m.group(1)), None))
            elif tok in ("c", "n", "o", "s"):
                atoms.append((SYMBOL_TO_Z[tok.upper()], True))
            else:
                atoms.append((SYMBOL_TO_Z[tok], False))
            i = m.end()
            expect_atom = False
        else:
            if ch in _BOND_CHARS:
                bonds.append(_BOND_CHARS[ch])
                i += 1
            else:
                bonds.append(None)  # implicit single-or-aromatic
            expect_atom = True
    return atoms, bonds


def _atom_ok(mol: Mol, i: int, spec) -> bool:
    z, arom = spec
    if z is not None and mol.atoms[i].z != z:
        return False
    if arom is not None and mol.atoms[i].aromatic != arom:
        return False
    return True


def _bond_ok(order: int, spec: Optional[int]) -> bool:
    if spec is None:
        return order in (1, AROMATIC)
    return order == spec


def match_paths(mol: Mol, smarts: str) -> List[Tuple[int, ...]]:
    """All unique simple paths matching the linear pattern (each undirected
    match once, like RDKit GetSubstructMatches(uniquify=True))."""
    perceive_aromaticity(mol)
    atom_specs, bond_specs = parse_path_smarts(smarts)
    k = len(atom_specs)
    out = set()
    results: List[Tuple[int, ...]] = []

    def extend(path: List[int]):
        d = len(path)
        if d == k:
            key = tuple(path) if tuple(path) <= tuple(reversed(path)) else tuple(reversed(path))
            if key not in out:
                out.add(key)
                results.append(tuple(path))
            return
        last = path[-1]
        for j in mol._adj[last]:
            if j in path:
                continue
            b = mol.bonds[mol._adj[last][j]]
            if not _bond_ok(b.order, bond_specs[d - 1]):
                continue
            if not _atom_ok(mol, j, atom_specs[d]):
                continue
            path.append(j)
            extend(path)
            path.pop()

    for start in range(mol.num_atoms):
        if _atom_ok(mol, start, atom_specs[0]):
            extend([start])
    return results


# -- geometry ---------------------------------------------------------------

def bond_length(pos: np.ndarray, i: int, j: int) -> float:
    return float(np.linalg.norm(pos[i] - pos[j]))


def bond_angle(pos: np.ndarray, i: int, j: int, k: int) -> float:
    """Angle at j in degrees."""
    v1 = pos[i] - pos[j]
    v2 = pos[k] - pos[j]
    cos = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-12)
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def dihedral_angle(pos: np.ndarray, i: int, j: int, k: int, l: int) -> float:
    """Torsion i-j-k-l in degrees, range (-180, 180]."""
    b0 = pos[i] - pos[j]
    b1 = pos[k] - pos[j]
    b2 = pos[l] - pos[k]
    b1n = b1 / (np.linalg.norm(b1) + 1e-12)
    v = b0 - np.dot(b0, b1n) * b1n
    w = b2 - np.dot(b2, b1n) * b1n
    x = np.dot(v, w)
    y = np.dot(np.cross(b1n, v), w)
    return float(np.degrees(np.arctan2(y, x)))


# -- Local3D ----------------------------------------------------------------

# frequent GEOM-Drug patterns (same sets as reference
# utils/evaluation.py:195-208)
PREDEFINED_BONDS = [
    "c:c", "[#6]-[#6]", "[#6]-[#7]", "[#6]-O", "c:n", "[#6]=O", "[#6]-S",
    "O=S", "c:o", "c:s", "[#6]-F", "n:n", "[#6]-Cl", "[#6]=[#6]", "[#7]-S",
    "[#6]=[#7]", "[#7]-[#7]", "[#7]-O", "[#6]=S", "[#7]=O",
]
PREDEFINED_ANGLES = [
    "c:c:c", "[#6]-[#6]-[#6]", "[#6]-[#7]-[#6]", "[#7]-[#6]-[#6]",
    "c:c-[#6]", "[#6]-O-[#6]", "O=[#6]-[#6]", "[#7]-c:c", "n:c:c", "c:c-O",
    "c:n:c", "[#6]-[#6]-O", "O=[#6]-[#7]",
]
PREDEFINED_DIHEDRALS = [
    "c:c:c:c", "[#6]-[#6]-[#6]-[#6]", "[#6]-[#7]-[#6]-[#6]", "[#6]-c:c:c",
    "[#7]-[#6]-[#6]-[#6]", "[#7]-c:c:c", "O-c:c:c", "[#6]-[#7]-c:c",
    "[#7]-[#6]-c:c", "n:c:c:c", "[#6]-[#7]-[#6]=O", "[#6]-[#6]-c:c",
    "c:c-[#7]-[#6]", "c:n:c:c", "[#6]-O-c:c",
]


class Local3D:
    def __init__(self, bonds=None, angles=None, dihedrals=None):
        self.bonds = bonds
        self.angles = angles
        self.dihedrals = dihedrals

    def get_predefined(self) -> None:
        self.bonds = list(PREDEFINED_BONDS)
        self.angles = list(PREDEFINED_ANGLES)
        self.dihedrals = list(PREDEFINED_DIHEDRALS)

    def calc_frequent(self, mols: Sequence[Mol], type_: str) -> Dict[str, np.ndarray]:
        assert type_ in ("length", "angle", "dihedral")
        patterns = {"length": self.bonds, "angle": self.angles,
                    "dihedral": self.dihedrals}[type_]
        results: Dict[str, np.ndarray] = {}
        for pat in patterns:
            vals: List[float] = []
            for mol in mols:
                pos = np.stack([a.pos for a in mol.atoms])
                for match in match_paths(mol, pat):
                    if type_ == "length":
                        vals.append(bond_length(pos, *match))
                    elif type_ == "angle":
                        vals.append(bond_angle(pos, *match))
                    else:
                        vals.append(dihedral_angle(pos, *match))
            results[pat] = np.asarray(vals)
        return results
