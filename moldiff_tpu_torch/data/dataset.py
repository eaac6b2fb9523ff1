"""Molecule records and the synthetic training corpora, built in memory.

A record is the JAX package's (moldiff_tpu/data/dataset.py): molid,
element [n] int16, pos [n_conf, n, 3] float32, bond_index [2, n_bonds]
int16 (each bond once, i < j, sorted by i * n + j) and bond_type [n_bonds]
int8. The JAX package reads records from a record store built from an SDF
directory; the port has no record store yet, and the corpora are not in
the repository, so :func:`make_corpus` generates one in memory with the
recipe of scripts/make_corpus.py: one ``np.random.Generator`` stream from
the corpus's seed, the v1 or v2 generator, molecule k named ``syn{k:05d}``,
and an 80/10/10 split in molid order. Molecule k equals the corpus's
``syn{k:05d}`` except that the SDF files round positions to 4 decimals.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..chem.mol import Mol

# scripts/make_corpus.py: corpus root -> (molecules, seed, chemistry)
CORPORA = {
    "./data/synthetic": (8_000, 7, "v1"),
    "./data/synthetic_full": (24_000, 2023, "v1"),
    "./data/synthetic_xl": (96_000, 2024, "v1"),
    "./data/synthetic_full2": (24_000, 3023, "v2"),
    "./data/synthetic_xl2": (96_000, 3024, "v2"),
}


def mol_to_arrays(mol: Mol) -> dict:
    """Mol -> canonical arrays; bonds sorted by flat (i*n + j) index with
    i < j (dataset.py:30-47)."""
    n = mol.num_atoms
    element = np.array([a.z for a in mol.atoms], dtype=np.int16)
    pos = np.stack([a.pos for a in mol.atoms]).astype(np.float32)
    bonds = sorted(((min(b.i, b.j), max(b.i, b.j), b.order) for b in mol.bonds),
                   key=lambda t: t[0] * n + t[1])
    if bonds:
        bi = np.array([[b[0] for b in bonds], [b[1] for b in bonds]], dtype=np.int16)
        bt = np.array([b[2] for b in bonds], dtype=np.int8)
    else:
        bi = np.zeros((2, 0), dtype=np.int16)
        bt = np.zeros((0,), dtype=np.int8)
    return {"element": element, "pos": pos, "bond_index": bi, "bond_type": bt}


def generate_records(n_mols: int, seed: int, chemistry: str = "v2",
                     n_atoms: Optional[Sequence[int]] = None) -> List[dict]:
    """The first ``n_mols`` molecules of the stream of ``seed`` as records
    (one conformer each); ``n_atoms``: molecule k drawn at n_atoms[k] atoms
    instead of the generator's size distribution."""
    if chemistry == "v2":
        from .synthetic_v2 import random_molecule_v2 as gen
    elif chemistry == "v1":
        from .synthetic import random_molecule as gen
    else:
        raise ValueError(f"unknown chemistry {chemistry!r}")
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_mols):
        arr = mol_to_arrays(gen(rng) if n_atoms is None else gen(rng, int(n_atoms[k])))
        arr["pos"] = arr["pos"][None]
        out.append({"molid": f"syn{k:05d}", **arr})
    return out


def make_corpus(root: str, n_mols: int) -> Dict[str, List[dict]]:
    """The first ``n_mols`` molecules of the corpus at ``root`` (a key of
    CORPORA, e.g. the train config's ``dataset.root``), split 80/10/10 by
    molid order -> {"train", "val", "test"} lists of records."""
    key = "./" + os.path.normpath(root)
    if key not in CORPORA:
        raise ValueError(f"no corpus recipe for {root!r}; known: {sorted(CORPORA)}")
    full, seed, chemistry = CORPORA[key]
    n_mols = min(int(n_mols), full)
    recs = generate_records(n_mols, seed, chemistry)
    n_tr, n_val = int(0.8 * n_mols), int(0.1 * n_mols)
    return {"train": recs[:n_tr], "val": recs[n_tr:n_tr + n_val], "test": recs[n_tr + n_val:]}
