"""Wildman-Crippen logP: the full published 68-type SMARTS table.

First-party implementation of the atom-contribution logP the reference gets
from RDKit (`reference/utils/scoring_func.py:28-87` Descriptors.MolLogP).
Atom types and contributions are the published Wildman & Crippen 1999 table
(J. Chem. Inf. Comput. Sci. 39, 868-873) — the same data RDKit ships as
Crippen.txt. Typing algorithm mirrors RDKit: per heavy atom, the FIRST
pattern (in table order, grouped per element) that matches rooted at the
atom assigns the type; implicit hydrogens are typed from their heavy
neighbor's environment (H1-H4).

Patterns are expressed in the chem/smarts.py subset. ``[#1]`` hydrogen
patterns from the original table are folded into the H-typing rules below
(all our hydrogens are implicit).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..chem import smarts
from ..chem.mol import Mol

# (type, SMARTS rooted at the typed atom, logP contribution)
# Carbon ---------------------------------------------------------------------
_CARBON: List[Tuple[str, str, float]] = [
    ("C1", "[CH4]", 0.1441),
    ("C1", "[CH3]C", 0.1441),
    ("C1", "[CH2](C)C", 0.1441),
    ("C2", "[CH1](C)(C)C", 0.0),
    ("C2", "[CH0](C)(C)(C)C", 0.0),
    ("C3", "[CH3][N,O,P,S,F,Cl,Br,I]", -0.2035),
    ("C3", "[CH2X4][N,O,P,S,F,Cl,Br,I]", -0.2035),
    ("C4", "[CH1X4][N,O,P,S,F,Cl,Br,I]", -0.2051),
    ("C4", "[CH0X4][N,O,P,S,F,Cl,Br,I]", -0.2051),
    ("C5", "[C]=[!#6;A]", -0.2783),
    ("C6", "[CH2]=C", 0.1551),
    ("C6", "[CH1](=C)[A]", 0.1551),
    ("C6", "[CH0](=C)([A])[A]", 0.1551),
    ("C6", "[C](=C)=C", 0.1551),
    ("C7", "[CX2]#[A]", 0.0017),
    ("C8", "[CH3]c", 0.08452),
    ("C9", "[CH3]a", -0.1444),  # after C8: non-carbon aromatic neighbor
    ("C10", "[CH2X4]a", -0.0516),
    ("C11", "[CHX4]a", 0.1193),
    ("C12", "[CH0X4]a", -0.0967),
    ("C13", "[cH0]-[!C;!N;!O;!S;!F;!Cl;!Br;!I;A]", -0.5443),
    ("C14", "[c][#9]", 0.0),
    ("C15", "[c][#17]", 0.245),
    ("C16", "[c][#35]", 0.198),
    ("C17", "[c][#53]", 0.0),
    ("C18", "[cH]", 0.1581),
    ("C19", "[c](:a)(:a):a", 0.2955),
    ("C20", "[c](:a)(:a)-a", 0.2713),
    ("C21", "[c](:a)(:a)-C", 0.136),
    ("C22", "[c](:a)(:a)-N", 0.4619),
    ("C23", "[c](:a)(:a)-O", 0.5437),
    ("C24", "[c](:a)(:a)-S", 0.1893),
    ("C25", "[c](:a)(:a)=[C,N,O]", -0.8186),
    ("C26", "[C](=C)(a)[A]", 0.2640),
    ("C26", "[C](=C)(c)a", 0.2640),
    ("C26", "[CH1](=C)a", 0.2640),
    ("C26", "[C]=c", 0.2640),
    ("C27", "[CX4][!C;!N;!O;!P;!S;!F;!Cl;!Br;!I;A]", 0.2148),
]
_CS = 0.08129  # carbon fallback

# Nitrogen -------------------------------------------------------------------
_NITROGEN: List[Tuple[str, str, float]] = [
    ("N1", "[NH2+0][A]", -1.0190),
    ("N2", "[NH+0]([A])[A]", -0.7096),
    ("N3", "[NH2+0]a", -1.0270),
    ("N4", "[NH+0]([!#1])a", -0.5188),
    ("N5", "[NH+0]=[!#1]", 0.08387),
    ("N6", "[N+0](=[!#1])[!#1]", 0.1836),
    ("N7", "[N+0]([A])([A])[A]", -0.3187),
    ("N8", "[N+0](a)([!#1])[A]", -0.4458),
    ("N8", "[N+0](a)(a)a", -0.4458),
    ("N9", "[N+0]#[A]", 0.01508),
    ("N10", "[NH3+]", -1.950),
    ("N10", "[NH2+]", -1.950),
    ("N10", "[NH1+]", -1.950),
    ("N11", "[n+0]", -0.3239),
    ("N12", "[n+]", -1.119),
    ("N13", "[NH0+]([A])([A])([A])[A]", -0.3396),
    ("N13", "[NH0+](=[A])([A])[!#1]", -0.3396),
    ("N13", "[NH0+](=[#6])=[#7]", -0.3396),
    ("N14", "[N+]#[A]", 0.2887),
    ("N14", "[N-]", 0.2887),
    ("N14", "[N+](=[N-])=N", 0.2887),
]
_NS = -0.4806  # nitrogen fallback

# Oxygen ---------------------------------------------------------------------
_OXYGEN: List[Tuple[str, str, float]] = [
    ("O1", "[o]", 0.1552),
    ("O2", "[OH]", -0.2893),
    ("O2", "[OH2]", -0.2893),
    ("O3", "[O]([A])[A]", -0.0684),
    ("O4", "[O](a)[!#1]", -0.4195),
    ("O5", "[O]=[#7,#8]", 0.0335),
    ("O5", "[OX1-][#7]", 0.0335),
    ("O6", "[OX1-][#16]", -0.3339),
    ("O12", "[O-]C(=O)", -1.326),   # before O7 (RDKit table order quirk)
    ("O7", "[OX1-][!#7;!#16]", -1.189),
    ("O8", "[O]=c", 0.1788),
    ("O9", "[O]=[CH]C", -0.1526),
    ("O9", "[O]=C(C)([A])", -0.1526),
    ("O9", "[O]=[CH][N,O]", -0.1526),
    ("O9", "[O]=[CH2]", -0.1526),
    ("O9", "[O]=[CX2]=O", -0.1526),
    ("O10", "[O]=[CH]c", 0.1129),
    ("O10", "[O]=C([C,c])[a]", 0.1129),
    ("O10", "[O]=C(c)[A]", 0.1129),
    ("O11", "[O]=C([!#1;!#6])[!#1;!#6]", 0.4833),
]
_OS = -0.1188  # oxygen fallback

# Other elements -------------------------------------------------------------
_F = 0.4202   # [#9-0]
_CL = 0.6895  # [#17-0]
_BR = 0.8456  # [#35-0]
_I = 0.8857   # [#53-0]
_HAL_ION = -2.996  # halide anions
_P = 0.8612
_S1 = 0.6482  # [S;-0]
_S2 = -0.0024  # charged S
_S3 = 0.6237  # [s]

# Hydrogen (implicit; typed by the heavy neighbor's environment) -------------
_H1 = 0.1230   # [#1][#6]
_H2 = -0.2677  # hydroxyl-ish / other
_H3 = 0.2142   # [#1][#7], [#1]O[#7]
_H4 = 0.2980   # acid/enol: [#1]OC=[C,N,O,S], [#1]O[O,S]


def _type_atom(mol: Mol, i: int, view) -> Tuple[str, float]:
    a = mol.atoms[i]
    if a.z == 6:
        for name, pat, val in _CARBON:
            if smarts.match_at(mol, pat, i, view=view):
                return name, val
        return "CS", _CS
    if a.z == 7:
        for name, pat, val in _NITROGEN:
            if smarts.match_at(mol, pat, i, view=view):
                return name, val
        return "NS", _NS
    if a.z == 8:
        for name, pat, val in _OXYGEN:
            if smarts.match_at(mol, pat, i, view=view):
                return name, val
        return "OS", _OS
    if a.z == 9:
        return ("Hal", _HAL_ION) if a.charge < 0 else ("F", _F)
    if a.z == 17:
        return ("Hal", _HAL_ION) if a.charge < 0 else ("Cl", _CL)
    if a.z == 35:
        return ("Hal", _HAL_ION) if a.charge < 0 else ("Br", _BR)
    if a.z == 53:
        return ("Hal", _HAL_ION) if a.charge < 0 else ("I", _I)
    if a.z == 15:
        return "P", _P
    if a.z == 16:
        if a.aromatic:
            return "S3", _S3
        return ("S2", _S2) if a.charge != 0 else ("S1", _S1)
    return "??", 0.0


def _h_contrib(mol: Mol, i: int, view) -> float:
    """Contribution of ONE implicit H on heavy atom i (Wildman-Crippen H1-H4;
    the original patterns are [#1]-rooted, folded here into neighbor tests)."""
    a = mol.atoms[i]
    if a.z == 6:
        return _H1
    if a.z == 7:
        return _H3
    if a.z == 8:
        # H-O-N -> H3; H-O-C=[C,N,O,S] or H-O-[O,S] -> H4 (acid/enol); else H2
        for j in mol.neighbors(i):
            nb = mol.atoms[j]
            if nb.z == 7:
                return _H3
            if nb.z in (8, 16):
                return _H4
            if nb.z == 6:
                for k in mol.neighbors(j):
                    b = mol.bond_between(j, k)
                    if b is not None and b.order == 2 and \
                            mol.atoms[k].z in (6, 7, 8, 16):
                        return _H4
        return _H2
    return _H2  # H on S/P/other heteroatoms


def atom_types(mol: Mol) -> List[str]:
    """Crippen type name per heavy atom (diagnostics / golden tests)."""
    view = smarts.MolView(mol)
    return [_type_atom(mol, i, view)[0] for i in range(mol.num_atoms)]


def logp(mol: Mol) -> float:
    """Wildman-Crippen logP with full atom typing + implicit-H terms."""
    view = smarts.MolView(mol)
    total = 0.0
    for i in range(mol.num_atoms):
        total += _type_atom(mol, i, view)[1]
        nh = mol.implicit_h(i)
        if nh:
            total += nh * _h_contrib(mol, i, view)
    return total


def mr_contributions() -> Dict[str, float]:  # pragma: no cover
    raise NotImplementedError("molar refractivity table not needed")
