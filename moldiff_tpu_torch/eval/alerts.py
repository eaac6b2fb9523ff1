"""Structural alerts (Brenk-style set) on the first-party SMARTS engine.

First-party replacement for the RDKit alert catalogs the reference relies on
(`reference/utils/scoring_func.py:77-87` PAINS filter; QED's ALERTS
descriptor uses the Brenk 2008 unwanted-substructure set). Patterns below
are the widely-distributed Brenk alerts expressible for the generator's
chemistry space (C, N, O, F, P, S, Cl + sanitizer charges); exotic-element
and very large patterns are omitted and documented here. Counting follows
RDKit QED: the ALERTS value is the number of DISTINCT alert patterns with at
least one match.
"""
from __future__ import annotations

from typing import Dict

from ..chem import smarts
from ..chem.mol import Mol

# name -> SMARTS (chem/smarts.py subset)
ALERTS: Dict[str, str] = {
    "acyl_halide": "[C,S](=[O,S])[F,Cl,Br,I]",
    "aldehyde": "[CX3H1]=O",
    "azide": "[N-]=[N+]=N",
    "azo": "[#6]N=N[#6]",
    "beta_lactam": "N1C(=O)CC1",
    "disulfide": "SS",
    "three_membered_heterocycle": "[#6]1[O,N,S][#6]1",
    "hydrazine": "[NX3][NX3]",
    "hydroxamic_acid": "C(=O)N[OH]",
    "acyclic_imine": "[#6]=[N;!R;!$(N~[O,N])]",
    "michael_acceptor": "[#6]=[#6][CX3]=[O,S]",
    "nitro": "[#7](=O)~[OX1]",
    "nitroso": "[#7;!$(N~[O,N])]=O",
    "oxime": "[#6]=N[OH]",
    "peroxide": "OO",
    "quaternary_nitrogen": "[N+;X4]",
    "sulfonic_acid_or_ester": "S(=O)(=O)[OX2]",
    "thiol": "[SX2H]",
    "thiocarbonyl": "[#6]=[SX1]",
    "isocyanate": "N=C=[O,S]",
    "thioester": "[SX2][CX3]=O",
    "anhydride": "C(=O)OC(=O)",
    "diketone_1_2": "[#6]C(=O)C(=O)[#6]",
    "enamine": "[#6]=[#6][NX3;!R]",
    "conjugated_nitrile": "[#6]=[#6]C#N",
    "aliphatic_long_chain": "[R0;D2][R0;D2][R0;D2][R0;D2]",
    "phosphorus": "[#15]",
    "charged_oxygen_anion": "[O-;!$([O-]C=O)]",
    "acetal_like": "[OX2][CX4][OX2]",
    "halogenated_methyl": "[CX4]([F,Cl,Br,I])([F,Cl,Br,I])[F,Cl,Br,I]",
    "n_oxide": "[#7+][OX1-]",
    "carbamate_nh": "[NX3]C(=O)[OX2]",
    "sulfate_ester": "[OX2]S(=O)(=O)[OX2]",
    "polyene": "[#6]=[#6][#6]=[#6][#6]=[#6]",
    "terminal_vinyl_ether": "[#6]=[#6][OX2][#6]",
}


def count_alerts(mol: Mol) -> Dict[str, int]:
    """Per-alert match counts (only alerts with >= 1 match)."""
    out: Dict[str, int] = {}
    for name, pat in ALERTS.items():
        n = smarts.count_matches(mol, pat)
        if n:
            out[name] = n
    return out


def num_alerts(mol: Mol) -> int:
    """Number of distinct alert patterns present (QED ALERTS semantics)."""
    view = smarts.MolView(mol)
    total = 0
    for pat in ALERTS.values():
        q = smarts.parse_cached(pat)
        if any(
            smarts.match_at(mol, q, i, view=view)
            for i in range(mol.num_atoms)
        ):
            total += 1
    return total


def passes_alert_filter(mol: Mol) -> bool:
    return num_alerts(mol) == 0
