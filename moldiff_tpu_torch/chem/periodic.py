"""Element data for the chemistry kernel.

First-party replacement for the slice of RDKit's periodic table that the
reference relies on (valence models in sanitization, atomic masses for MW,
covalent radii for distance-based bond perception replacing
`reference/utils/edm_bond.py`'s empirical tables).

Sources (public reference data):
  * atomic masses: IUPAC 2021 standard atomic weights (rounded)
  * covalent radii: Cordero et al., Dalton Trans. 2008 (single bond);
    Pyykko & Atsumi, Chem. Eur. J. 2009 (double/triple bond radii)
  * default valences: standard organic chemistry valence models
"""
from __future__ import annotations

ELEMENTS = {
    1: "H", 5: "B", 6: "C", 7: "N", 8: "O", 9: "F", 14: "Si", 15: "P",
    16: "S", 17: "Cl", 35: "Br", 53: "I",
}
SYMBOL_TO_Z = {v: k for k, v in ELEMENTS.items()}

ATOMIC_MASS = {
    1: 1.008, 5: 10.81, 6: 12.011, 7: 14.007, 8: 15.999, 9: 18.998,
    14: 28.085, 15: 30.974, 16: 32.06, 17: 35.45, 35: 79.904, 53: 126.904,
}

# Allowed total valences (bond-order sums incl. implicit H) per element at
# formal charge 0, in preference order (first = default for implicit-H fill).
DEFAULT_VALENCES = {
    1: (1,),
    5: (3,),
    6: (4,),
    7: (3,),
    8: (2,),
    9: (1,),
    14: (4,),
    15: (3, 5),
    16: (2, 4, 6),
    17: (1,),
    35: (1,),
    53: (1, 3, 5),  # hypervalent iodine rare but legal
}

# charge -> {element: allowed valences}; mirrors the charge fixes the
# reference applies in fix_valence (utils/reconstruct.py:295-315: N+) plus
# the standard O-/N-/S+ cases RDKit accepts.
CHARGED_VALENCES = {
    +1: {7: (4,), 8: (3,), 16: (3, 5)},
    -1: {5: (4,), 6: (3,), 7: (2,), 8: (1,), 16: (1,)},
}

# Electronegativity (Pauling) — used only for canonical tie-breaking.
ELECTRONEGATIVITY = {
    1: 2.20, 5: 2.04, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98, 14: 1.90,
    15: 2.19, 16: 2.58, 17: 3.16, 35: 2.96, 53: 2.66,
}

# Covalent radii in Angstrom, by bond order (1, 2, 3). Values from Cordero
# 2008 (order 1) and Pyykko & Atsumi 2009 (orders 2, 3).
COVALENT_RADIUS = {
    1: {1: 0.31},
    5: {1: 0.84, 2: 0.78, 3: 0.73},
    6: {1: 0.76, 2: 0.67, 3: 0.60},
    7: {1: 0.71, 2: 0.60, 3: 0.54},
    8: {1: 0.66, 2: 0.57, 3: 0.53},
    9: {1: 0.57, 2: 0.59},
    14: {1: 1.11, 2: 1.07, 3: 1.02},
    15: {1: 1.07, 2: 1.02, 3: 0.94},
    16: {1: 1.05, 2: 0.94, 3: 0.95},
    17: {1: 1.02, 2: 0.95},
    35: {1: 1.20, 2: 1.14},
    53: {1: 1.39, 2: 1.33},
}

# SMILES "organic subset" — atoms writable without brackets at charge 0.
ORGANIC_SUBSET = {5, 6, 7, 8, 9, 15, 16, 17, 35, 53}

# Elements that can be aromatic in SMILES output.
AROMATIC_ELEMENTS = {5, 6, 7, 8, 15, 16}


def max_valence(z: int, charge: int = 0) -> int:
    if charge != 0 and charge in CHARGED_VALENCES and z in CHARGED_VALENCES[charge]:
        return max(CHARGED_VALENCES[charge][z])
    return max(DEFAULT_VALENCES.get(z, (4,)))


def allowed_valences(z: int, charge: int = 0):
    if charge == 0:
        return DEFAULT_VALENCES.get(z, ())
    return CHARGED_VALENCES.get(charge, {}).get(z, ())
