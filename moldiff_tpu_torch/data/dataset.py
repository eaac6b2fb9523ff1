"""Molecule records: the SDF-directory dataset read through a record store
(moldiff_tpu/data/dataset.py), and the synthetic training corpora built in
memory.

A record is the JAX package's: molid, element [n] int16, pos [n_conf, n, 3]
float32, bond_index [2, n_bonds] int16 (each bond once, i < j, sorted by
i * n + j) and bond_type [n_bonds] int8.

:class:`Drug3DDataset` reads a reference-layout directory (``sdf/<molid>.sdf``,
``mol_summary.csv``, a split file) and packs the records into a record
store (data/record_store.py) on first use, in the JAX package's order and
bytes; :func:`get_dataset` splits it by the split file.

:func:`make_corpus` generates a corpus in memory with the recipe of
scripts/make_corpus.py: one ``np.random.Generator`` stream from the
corpus's seed, the v1 or v2 generator, molecule k named ``syn{k:05d}``,
and an 80/10/10 split in molid order. Molecule k equals the corpus
directory's ``syn{k:05d}`` except that the SDF files round positions to 4
decimals.
"""
from __future__ import annotations

import concurrent.futures
import csv
import multiprocessing
import os
import pickle
import re
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..chem.mol import Mol
from ..chem.sdf import read_sdf
from .record_store import RecordReader, RecordWriter

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


def _check_conformers(recs: list, molid) -> Optional[dict]:
    """One record from a molecule's conformers (array dicts, None where a
    conformer did not parse), or None when none parsed or the conformers
    disagree on atoms or bonds (reference utils/parser.py:26-57)."""
    recs = [r for r in recs if r is not None]
    if not recs:
        return None
    base = recs[0]
    for r in recs[1:]:
        if not all(np.array_equal(r[k], base[k]) for k in ("element", "bond_index", "bond_type")):
            return None
    return {"molid": molid, "element": base["element"], "pos": np.stack([r["pos"] for r in recs]),
            "bond_index": base["bond_index"], "bond_type": base["bond_type"]}


def parse_conf_list(mols: Sequence[Optional[Mol]], molid=None) -> Optional[dict]:
    """A multi-conformer SDF's Mols -> one record (None: inconsistent or
    empty)."""
    return _check_conformers([None if m is None else mol_to_arrays(m) for m in mols], molid)


def parse_conf_arrays(recs, molid=None) -> Optional[dict]:
    """:func:`parse_conf_list` for the native parser's array records
    (chem/sdf_native.py read_sdf_arrays: no Mol objects built)."""
    return _check_conformers(list(recs), molid)


PARSERS = ("native", "python")


def _parse_one(molid, sdf_dir: str, parser: str = "native") -> Optional[dict]:
    """The record of ``<sdf_dir>/<molid>.sdf``, or None when the file is
    missing or does not give a consistent molecule. The native parser is
    loaded (built on first use) before the parse, outside the ``try`` that
    counts a bad molecule as skipped: a build or load failure raises."""
    if parser == "native":
        from ..chem import sdf_native

        sdf_native.library()
    elif parser != "python":
        raise ValueError(f"parser must be one of {PARSERS}, not {parser!r}")
    sdf_path = os.path.join(sdf_dir, f"{molid}.sdf")
    if not os.path.exists(sdf_path):
        return None
    try:
        if parser == "native":
            return parse_conf_arrays(sdf_native.read_sdf_arrays(sdf_path), molid=molid)
        return parse_conf_list(list(read_sdf(sdf_path)), molid=molid)
    except Exception:
        return None


def _parse_one_pickled(args) -> Optional[bytes]:
    """Worker: parse one molecule and pickle it (bytes cross the process
    boundary once; the writer appends them as they are)."""
    rec = _parse_one(*args)
    if rec is None:
        return None
    return pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)


# pandas.read_csv's default missing-value and boolean spellings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
         "false": False}
_INT = re.compile(r"[+-]?\d+")


def _is_number(cell: str) -> bool:
    try:
        float(cell)
    except ValueError:
        return False
    return True


def _truth(cells: Sequence[str]) -> List[bool]:
    """``df[col].astype(bool)`` for one column of a CSV read by pandas: a
    True/False column keeps its values, a numeric one is true where nonzero,
    any other cell is true, and a missing value (NaN) is true."""
    if all(c in _NA or c in _BOOL for c in cells):
        return [c in _NA or _BOOL[c] for c in cells]
    if all(c in _NA or _is_number(c) for c in cells):
        return [c in _NA or float(c) != 0.0 for c in cells]
    return [True] * len(cells)


def read_summary(path: str) -> list:
    """The molids of ``mol_summary.csv`` that pass the reference filters
    (utils/dataset.py:94-95: pass_size & pass_element & ~broken &
    ~error_mol; a filter whose column is absent passes), in file order. The
    id column is ``molid``, else the first; its values are ints when every
    one is, as pandas reads them."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], [r for r in rows[1:] if r]
    columns = {name: [r[k] if k < len(r) else "" for r in rows] for k, name in enumerate(header)}
    keep = [True] * len(rows)
    for col, want in (("pass_size", True), ("pass_element", True), ("broken", False),
                      ("error_mol", False)):
        if col in columns:
            keep = [k and t == want for k, t in zip(keep, _truth(columns[col]))]
    ids = columns["molid" if "molid" in columns else header[0]]
    if all(_INT.fullmatch(c) for c in ids):
        ids = [int(c) for c in ids]
    return [m for m, k in zip(ids, keep) if k]


# the layout of a dataset directory (the train configs' dataset.path_dict)
DEFAULT_PATH_DICT = {"sdf": "sdf", "summary": "mol_summary.csv", "processed": "processed.mdb"}


class Drug3DDataset:
    """A record-store-backed molecule dataset, processed from its SDF
    directory on first use.

    ``path_dict`` (the train configs' ``dataset.path_dict``; a key it lacks
    takes DEFAULT_PATH_DICT's): ``sdf`` (the SDF directory), ``summary``
    (the CSV; without it every ``*.sdf`` file, sorted) and ``processed``
    (the store, its extension dropped) under ``root``. ``parser``: "native" (chem/sdf_native.py, built on first use)
    or "python" (chem/sdf.py).
    """

    def __init__(self, root: str, path_dict: Optional[dict] = None, transform=None,
                 parser: str = "native"):
        if parser not in PARSERS:
            raise ValueError(f"parser must be one of {PARSERS}, not {parser!r}")
        path_dict = {**DEFAULT_PATH_DICT, **(path_dict or {})}
        self.root = root
        self.parser = parser
        self.sdf_dir = os.path.join(root, path_dict["sdf"])
        self.summary_path = os.path.join(root, path_dict["summary"])
        self.store_path = os.path.join(root, os.path.splitext(path_dict["processed"])[0])
        self.transform = transform
        self._reader: Optional[RecordReader] = None
        self._molid2idx: Optional[Dict] = None
        if not os.path.exists(self.store_path + ".idx"):
            self._process()

    def _iter_summary(self) -> Iterator:
        if os.path.exists(self.summary_path):
            yield from read_summary(self.summary_path)
        else:
            for fn in sorted(os.listdir(self.sdf_dir)):
                if fn.endswith(".sdf"):
                    yield os.path.splitext(fn)[0]

    def _process(self, n_workers: Optional[int] = None) -> tuple:
        """Parse and pack every molecule -> (packed, skipped). Above 64
        molecules the parsing fans out over a pool of ``spawn`` workers
        (a forked child of a process with CUDA and torch's threads running
        can deadlock), which import only data/, chem/ and numpy; ``map``
        keeps the order, so the store is the serial path's byte for byte."""
        if not os.path.isdir(self.sdf_dir):
            raise FileNotFoundError(f"{self.root}: no record store ({self.store_path}.idx) and "
                                    f"no SDF directory ({self.sdf_dir}) to build it from")
        os.makedirs(os.path.dirname(os.path.abspath(self.store_path)), exist_ok=True)
        if self.parser == "native":
            from ..chem import sdf_native

            sdf_native.library()   # build here, once, and raise if it fails
        molids = list(self._iter_summary())
        n_workers = n_workers or min(max(multiprocessing.cpu_count() - 1, 1), 32)
        n_ok = n_bad = 0
        with RecordWriter(self.store_path) as w:
            if n_workers > 1 and len(molids) > 64:
                args = [(m, self.sdf_dir, self.parser) for m in molids]
                # a worker that dies raises BrokenProcessPool here (a
                # multiprocessing.Pool would start another, and wait forever)
                with concurrent.futures.ProcessPoolExecutor(
                        n_workers, mp_context=multiprocessing.get_context("spawn")) as pool:
                    for blob in pool.map(_parse_one_pickled, args, chunksize=32):
                        if blob is None:
                            n_bad += 1
                        else:
                            w.append_bytes(blob)
                            n_ok += 1
            else:
                for molid in molids:
                    rec = _parse_one(molid, self.sdf_dir, self.parser)
                    if rec is None:
                        n_bad += 1
                    else:
                        w.append(rec)
                        n_ok += 1
        if n_bad:
            print(f"[dataset] processed {n_ok} molecules, skipped {n_bad}")
        return n_ok, n_bad

    @property
    def reader(self) -> RecordReader:
        if self._reader is None:
            self._reader = RecordReader(self.store_path)
        return self._reader

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, i: int) -> dict:
        rec = self.reader[i]
        if self.transform is not None:
            rec = self.transform(rec)
        return rec

    @property
    def molid2idx(self) -> Dict:
        if self._molid2idx is None:
            self._molid2idx = {self.reader[i]["molid"]: i for i in range(len(self.reader))}
        return self._molid2idx


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def get_dataset(config, transform=None, parser: str = "native"):
    """(dataset, {split: Subset}) from a dataset config section (root,
    path_dict, split). The split file is a pickle {split: [molid]} or the
    reference's torch.save'd split_by_molid.pt; molids missing from the
    store are left out. Without a split file, "train" is every record."""
    dataset = Drug3DDataset(config["root"], dict(config["path_dict"]), transform=transform,
                            parser=parser)
    subsets = {}
    split_path = os.path.join(config["root"], config.get("split", ""))
    if config.get("split") and os.path.exists(split_path):
        from .convert_lmdb import load_reference_split

        split = load_reference_split(split_path)
        m2i = dataset.molid2idx
        for name, molids in split.items():
            subsets[name] = Subset(dataset, [m2i[m] for m in molids if m in m2i])
    else:
        subsets["train"] = Subset(dataset, range(len(dataset)))
    return dataset, subsets
