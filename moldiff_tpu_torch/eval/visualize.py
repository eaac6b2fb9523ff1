"""Molecule visualization helpers.

First-party analogue of `reference/utils/visualize.py` (py3Dmol /
RDKit drawing). Neither dependency ships in this image, so rendering uses
matplotlib when available (3D ball-and-stick + 2D graph layout) and always
provides text fallbacks (SMILES, ASCII adjacency).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..chem.mol import AROMATIC, Mol
from ..chem.smiles import mol_to_smiles

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAS_MPL = True
except Exception:  # pragma: no cover
    HAS_MPL = False

_ELEMENT_COLOR = {
    6: "#404040", 7: "#3050F8", 8: "#FF0D0D", 9: "#90E050",
    15: "#FF8000", 16: "#FFFF30", 17: "#1FF01F", 35: "#A62929", 53: "#940094",
}
_ELEMENT_SIZE = {6: 70, 7: 65, 8: 60, 9: 50, 15: 100, 16: 100, 17: 100}


def show_mol(mol: Mol, path: str, title: Optional[str] = None) -> bool:
    """Render a 3D ball-and-stick PNG; returns False if matplotlib is
    unavailable or the molecule has no coordinates."""
    if not HAS_MPL or any(a.pos is None for a in mol.atoms):
        return False
    pos = np.stack([a.pos for a in mol.atoms])
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    for b in mol.bonds:
        seg = pos[[b.i, b.j]]
        lw = {1: 1.5, 2: 3.0, 3: 4.5, AROMATIC: 2.5}[b.order]
        ls = "--" if b.order == AROMATIC else "-"
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c="#808080", lw=lw, ls=ls)
    for i, a in enumerate(mol.atoms):
        ax.scatter(*pos[i], s=_ELEMENT_SIZE.get(a.z, 80),
                   c=_ELEMENT_COLOR.get(a.z, "#FF00FF"), edgecolors="k",
                   linewidths=0.5, depthshade=True)
    ax.set_title(title or mol_to_smiles(mol))
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def show_mols_grid(mols: List[Mol], path: str, cols: int = 4) -> bool:
    """Grid of 3D renders for a molecule batch."""
    if not HAS_MPL:
        return False
    rows = (len(mols) + cols - 1) // cols
    fig = plt.figure(figsize=(4 * cols, 4 * rows))
    for k, mol in enumerate(mols):
        if any(a.pos is None for a in mol.atoms):
            continue
        pos = np.stack([a.pos for a in mol.atoms])
        ax = fig.add_subplot(rows, cols, k + 1, projection="3d")
        for b in mol.bonds:
            seg = pos[[b.i, b.j]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c="#808080", lw=1.5)
        for i, a in enumerate(mol.atoms):
            ax.scatter(*pos[i], s=_ELEMENT_SIZE.get(a.z, 80) * 0.6,
                       c=_ELEMENT_COLOR.get(a.z, "#FF00FF"), edgecolors="k",
                       linewidths=0.4)
        ax.set_title(mol_to_smiles(mol), fontsize=7)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def mol_summary_text(mol: Mol) -> str:
    """Text rendering: SMILES + atom/bond table (always available)."""
    lines = [f"SMILES: {mol_to_smiles(mol)}",
             f"atoms: {mol.num_atoms}  bonds: {mol.num_bonds}  "
             f"rings: {len(mol.ring_info())}"]
    for i, a in enumerate(mol.atoms):
        nb = ",".join(
            f"{j}({mol.bonds[mol._adj[i][j]].order})" for j in mol.neighbors(i)
        )
        lines.append(f"  {i:3d} {a.symbol:2s} chg={a.charge:+d} -> {nb}")
    return "\n".join(lines)
