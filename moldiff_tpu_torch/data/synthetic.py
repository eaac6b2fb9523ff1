"""Random valence-respecting molecules (a copy of
moldiff_tpu/data/synthetic.py): trees plus ring closures over
C/N/O/F/S/Cl with a crude force-layout for coordinates (the v2 generator,
synthetic_v2.py, falls back to it), and :func:`make_synthetic_dataset`,
which writes a corpus as a reference-layout SDF directory.
"""
from __future__ import annotations

import csv
import os
import pickle
from typing import Optional

import numpy as np

from ..chem.mol import Mol
from ..chem.periodic import DEFAULT_VALENCES
from ..chem.sanitize import sanitize

_ELEMENTS = [6, 6, 6, 6, 6, 6, 7, 7, 8, 8, 9, 16, 17]  # weighted draw


def random_molecule(
    rng: np.random.Generator, n_atoms: Optional[int] = None,
    ring_prob: float = 0.3, double_prob: float = 0.15,
) -> Mol:
    """Random connected molecule with legal valences."""
    if n_atoms is None:
        n_atoms = int(np.clip(rng.normal(18, 5), 4, 40))
    mol = Mol()
    free = []  # remaining valence per atom
    z0 = 6  # root is always carbon so growth can't dead-end immediately
    mol.add_atom(z0)
    free.append(DEFAULT_VALENCES[z0][0])

    # grow a spanning tree atom by atom; attach only to atoms with free
    # valence, stop early if the molecule saturates
    while mol.num_atoms < n_atoms:
        cands = [j for j in range(mol.num_atoms) if free[j] > 0]
        if not cands:
            break
        z = int(_ELEMENTS[rng.integers(len(_ELEMENTS))])
        i = mol.add_atom(z)
        free.append(DEFAULT_VALENCES[z][0])
        j = int(cands[rng.integers(len(cands))])
        order = 1
        if double_prob > 0 and free[j] >= 2 and free[i] >= 2 and rng.random() < double_prob:
            order = 2
        mol.add_bond(i, j, order)
        free[i] -= order
        free[j] -= order
    n_atoms = mol.num_atoms

    # extra ring-closing bonds
    n_rings = rng.binomial(max(n_atoms // 6, 1), ring_prob)
    for _ in range(n_rings):
        cands = [k for k in range(n_atoms) if free[k] > 0]
        if len(cands) < 2:
            break
        i, j = rng.choice(cands, size=2, replace=False)
        i, j = int(i), int(j)
        if i == j or mol.bond_between(i, j) is not None:
            continue
        mol.add_bond(i, j, 1)
        free[i] -= 1
        free[j] -= 1

    _embed_coords(mol, rng)
    sanitize(mol)
    return mol


def _embed_coords(mol: Mol, rng: np.random.Generator, iters: int = 60) -> None:
    """Crude force layout: bonded pairs -> ~1.5 A, non-bonded repelled."""
    n = mol.num_atoms
    pos = rng.normal(scale=2.0, size=(n, 3))
    bonded = np.zeros((n, n), dtype=bool)
    for b in mol.bonds:
        bonded[b.i, b.j] = bonded[b.j, b.i] = True
    for it in range(iters):
        diff = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(diff, axis=-1) + 1e-6
        np.fill_diagonal(dist, np.inf)
        unit = diff / dist[..., None]
        f = np.zeros_like(pos)
        spring = np.where(bonded, dist - 1.5, 0.0)
        f -= np.sum(spring[..., None] * unit, axis=1) * 0.5
        rep = np.where(~bonded & (dist < 2.0), (2.0 - dist), 0.0)
        np.fill_diagonal(rep, 0.0)
        f += np.sum(rep[..., None] * unit, axis=1) * 0.3
        # damped, clipped step so the layout can't explode
        step = 0.5 * (1.0 - it / iters) + 0.05
        f = np.clip(f, -1.0, 1.0)
        pos += step * f
    pos -= pos.mean(axis=0)
    for i, a in enumerate(mol.atoms):
        a.pos = pos[i].astype(np.float64)


def make_synthetic_dataset(root: str, n_mols: int = 200, seed: int = 0, n_confs: int = 1,
                           chemistry: str = "v1") -> None:
    """Write a reference-layout dataset directory: sdf/<molid>.sdf,
    mol_summary.csv and split_by_molid.pkl (80/10/10 in molid order), the
    JAX package's bytes for the same arguments. ``chemistry``: "v1" (this
    module's generator) or "v2" (synthetic_v2.py: aromatic rings, triple
    bonds, GEOM-Drug size statistics). Conformers after the first are the
    same graph re-laid out from the same stream."""
    from ..chem.sdf import write_sdf

    if chemistry == "v2":
        from .synthetic_v2 import random_molecule_v2 as gen
    else:
        gen = random_molecule

    rng = np.random.default_rng(seed)
    sdf_dir = os.path.join(root, "sdf")
    os.makedirs(sdf_dir, exist_ok=True)
    molids = []
    for k in range(n_mols):
        molid = f"syn{k:05d}"
        mol = gen(rng)
        confs = [mol]
        for _ in range(n_confs - 1):
            c = mol.copy()
            _embed_coords(c, rng)
            confs.append(c)
        write_sdf(confs, os.path.join(sdf_dir, f"{molid}.sdf"))
        molids.append(molid)
    with open(os.path.join(root, "mol_summary.csv"), "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["molid", "pass_size", "pass_element", "broken", "error_mol"])
        for m in molids:
            wr.writerow([m, True, True, False, False])
    n_tr = int(0.8 * n_mols)
    n_val = int(0.1 * n_mols)
    split = {"train": molids[:n_tr], "val": molids[n_tr:n_tr + n_val],
             "test": molids[n_tr + n_val:]}
    with open(os.path.join(root, "split_by_molid.pkl"), "wb") as f:
        pickle.dump(split, f)
