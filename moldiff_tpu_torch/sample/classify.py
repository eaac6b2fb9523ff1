"""Classifying decoded molecules into the sampling pool, serially or over a
pool of worker processes (moldiff_tpu/sample/pipeline.py:459-568).

:func:`classify_decoded` turns one decoded molecule into a pool entry
(the sanitize cascade, then the disconnect check); :func:`classify_batch`
does it for a batch, in order, through a pool from
:func:`make_classify_pool` when one is given. The pool's workers are
``spawn``ed (a forked child of a process with CUDA and torch's threads
running can deadlock) and import this module alone: chem/ and numpy,
neither torch nor the models, so they never touch a card. It is a
``concurrent.futures.ProcessPoolExecutor``: a job that raises raises in
the caller, and a worker that dies raises ``BrokenProcessPool`` there
(a ``multiprocessing.Pool`` would start another worker and wait forever).
``map`` keeps the order, so the pooled entries are the serial ones, entry
for entry.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
from typing import List, Optional

import numpy as np

from ..chem.bond_perception import mol_from_positions, mol_from_positions_ctd
from ..chem.mol import MolError
from ..chem.sanitize import reconstruct_from_generated, sanitize
from ..chem.smiles import mol_to_smiles

# molecules per job sent to a worker (pipeline.py:498)
CHUNKSIZE = 16


def classify_decoded(decoded: dict, add_edge: Optional[str] = None,
                     sanitize_mode: str = "reference") -> dict:
    """Decoded dict -> pool entry: sanitize cascade + disconnect check
    (pipeline.py:503-568). ``add_edge``: None reads the model's bonds;
    'distance' (or 'edm') perceives them from interatomic distances, and
    'connect' by connect-the-dots with geometric bond orders."""
    stats: dict = {}
    try:
        if add_edge in ("distance", "edm"):
            # distance bonds carry no aromatic class: sanitize alone, with
            # the acceptance sanitize_mode sets
            mol = sanitize(mol_from_positions(decoded["element"], decoded["atom_pos"]),
                           auto_pyrrole=(sanitize_mode != "reference"))
            stats["stage"] = "sanitize"
        elif add_edge == "connect":
            perceived = mol_from_positions_ctd(decoded["element"], decoded["atom_pos"])
            bi = np.array([[b.i for b in perceived.bonds], [b.j for b in perceived.bonds]],
                          dtype=np.int64)
            bt = np.array([b.order for b in perceived.bonds], dtype=np.int64)
            mol = reconstruct_from_generated(decoded["element"], decoded["atom_pos"], bi, bt,
                                             mode=sanitize_mode, stats=stats)
        else:
            mol = reconstruct_from_generated(
                decoded["element"], decoded["atom_pos"], decoded.get("bond_index"),
                decoded.get("bond_type"), mode=sanitize_mode, stats=stats)
    except MolError:
        return {"pool": "failed", "decoded": decoded, "reason": "recon_error"}
    try:
        smiles = mol_to_smiles(mol)
    except Exception:
        return {"pool": "failed", "decoded": decoded, "reason": "smiles_error"}
    if "." in smiles:
        return {"pool": "failed", "decoded": decoded, "reason": "disconnect",
                "mol": mol, "smiles": smiles, "stage": stats.get("stage")}
    return {"pool": "finished", "decoded": decoded, "mol": mol,
            "smiles": smiles, "stage": stats.get("stage")}


def _classify_job(args: tuple) -> dict:
    decoded, add_edge, sanitize_mode = args
    return classify_decoded(decoded, add_edge=add_edge, sanitize_mode=sanitize_mode)


def make_classify_pool(workers: Optional[int]):
    """A spawn-context pool of ``workers`` processes, or None (serial) for
    0, 1 or None (pipeline.py:477-487). The caller shuts it down."""
    if workers is None or workers <= 1:
        return None
    return concurrent.futures.ProcessPoolExecutor(
        int(workers), mp_context=multiprocessing.get_context("spawn"))


def classify_batch(decoded_list: list, add_edge: Optional[str] = None, pool=None,
                   sanitize_mode: str = "reference") -> List[dict]:
    """:func:`classify_decoded` over a batch, in order: through ``pool``
    (:func:`make_classify_pool`) in jobs of CHUNKSIZE molecules, or in this
    process (pipeline.py:490-500)."""
    if pool is None:
        return [classify_decoded(d, add_edge=add_edge, sanitize_mode=sanitize_mode)
                for d in decoded_list]
    return list(pool.map(_classify_job, [(d, add_edge, sanitize_mode) for d in decoded_list],
                         chunksize=CHUNKSIZE))
