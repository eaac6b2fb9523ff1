"""Evaluate generated molecules (or a dataset split) across all metric
families (scripts/evaluate_all.py, without pandas).

  # a sample output directory (python -m moldiff_tpu_torch.sample, or the
  # JAX CLI: the same layout)
  python -m moldiff_tpu_torch.eval --from_where generated --root <out_dir>

  # a dataset split: a dataset directory (its record store, built from its
  # SDF directory on first use), or a corpus recipe of data/dataset.py's
  # CORPORA made in memory
  python -m moldiff_tpu_torch.eval --from_where dataset \
      --dataset_root ./data/synthetic --split test [--corpus_mols N]

  # bare SMILES list (one per line; 2D families only: no conformers)
  python -m moldiff_tpu_torch.eval --from_where smiles --root SMILES.txt

Writes mols.csv (per-molecule metrics; byte-equal to the JAX script's
``pd.DataFrame(rows).fillna(0).to_csv(index=False)``), validity.json (under
the run's ``sanitize_mode``), similarity.json (generated molecules against
the train and val splits of ``--dataset_root``), local3d.pkl and
freq_ring_type.pkl. Host code only: nothing here imports torch, so
``--parallel`` forks its worker pool from a process with no CUDA context.
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import math
import numbers
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence

from ..chem.mol import Mol, MolError
from ..chem.sanitize import sanitize
from ..chem.sdf import read_sdf
from ..utils.misc import get_logger
from .local3d import Local3D
from .metrics import RingAnalyzer, calculate_validity, get_metric
from .sa_score import _default_scorer
from .similarity import SimilarityAnalysis

FAMILIES = ("drug_chem", "count_prop", "frags_counts", "groups_counts", "ring_topo")
LOGGER = "moldiff_tpu_torch.eval"


def load_generated(root: str):
    """Load mols from a sample output dir (SDF/*.sdf + samples_all.pkl for
    the validity pools)."""
    mols = []
    for fn in sorted(glob.glob(os.path.join(root, "SDF", "*.sdf"))):
        for m in read_sdf(fn):
            if m is None:
                continue
            try:
                sanitize(m)
                mols.append(m)
            except MolError:
                pass
    decoded = []
    pkl = os.path.join(root, "samples_all.pkl")
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            blob = pickle.load(f)
        decoded = [e["decoded"] for e in blob.get("finished", [])] + [
            e["decoded"] for e in blob.get("failed", [])
        ]
    return mols, decoded


def load_smiles_file(path: str, limit=None):
    """One SMILES per line (optionally followed by a name) -> sanitized
    Mols; unparseable lines are skipped with a count."""
    from ..chem.smiles import SmilesError, mol_from_smiles

    mols, skipped = [], 0
    with open(path) as f:
        for line in f:
            token = line.split()[0] if line.split() else ""
            if not token:
                continue
            try:
                mols.append(mol_from_smiles(token))
            except (SmilesError, MolError):
                skipped += 1
            if limit and len(mols) >= limit:
                break
    return mols, skipped


def load_dataset_mols(dataset_root: str, split: str, limit=None,
                      corpus_mols: Optional[int] = None) -> List[Mol]:
    """The sanitized molecules of one split of the dataset at
    ``dataset_root`` (the first conformer of each). A directory is read
    through its record store (data/dataset.py get_dataset, processed from
    its SDF directory on first use), as the JAX script reads it
    (scripts/evaluate_all.py:93). Otherwise the root must be a key of
    data/dataset.py's CORPORA, made in memory by its recipe (the first
    ``corpus_mols`` molecules, split 80/10/10; by default the whole
    corpus), which differs from the corpus directory only in positions (the
    SDF files round them to 4 decimals); any other root raises."""
    from ..data.dataset import CORPORA, DEFAULT_PATH_DICT, get_dataset, make_corpus

    if os.path.isdir(dataset_root):
        _, subsets = get_dataset({"root": dataset_root, "path_dict": DEFAULT_PATH_DICT,
                                  "split": "split_by_molid.pkl"})
    else:
        key = "./" + os.path.normpath(dataset_root)
        if key not in CORPORA:
            raise ValueError(f"{dataset_root!r} is neither a directory nor a corpus recipe "
                             f"({sorted(CORPORA)})")
        subsets = make_corpus(dataset_root, corpus_mols or CORPORA[key][0])
    subset = subsets.get(split) or subsets["train"]
    mols = []
    n = len(subset) if limit is None else min(limit, len(subset))
    for i in range(n):
        rec = subset[i]
        mol = Mol.from_arrays(
            rec["element"], rec["pos"][0], rec["bond_index"], rec["bond_type"]
        )
        try:
            sanitize(mol)
            mols.append(mol)
        except MolError:
            pass
    return mols


def score_rows(mols: Sequence[Mol], families: Sequence[str], parallel: bool = False):
    """(rows, empty): one dict per molecule with every family's metrics,
    and for each family the indices of the molecules it returned nothing
    for (get_metric turns a failing metric into an empty dict, which
    mols.csv shows as zeros)."""
    rows: List[dict] = [dict() for _ in mols]
    empty: Dict[str, List[int]] = {}
    for family in families:
        got = get_metric(mols, family, parallel=parallel)
        empty[family] = [i for i, d in enumerate(got) if not d]
        for r, d in zip(rows, got):
            r.update(d)
    return rows, empty


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _kind(values: Sequence) -> str:
    """pandas' dtype for a column of metric values (None: a row without
    the key): 'int' when every value is an integer, else 'float'. The
    metric families return numbers only; pandas would print a bool or a
    string otherwise, so those raise."""
    for v in values:
        if isinstance(v, bool) or not (v is None or isinstance(v, numbers.Real)):
            raise TypeError(f"not a metric value: {v!r}")
    if all(isinstance(v, numbers.Integral) for v in values):
        return "int"
    return "float"


def _cell(v, kind: str, fill_zero: bool) -> str:
    """One CSV field as pandas writes it; a missing value reads as the 0
    that fillna(0) puts there or, without it, as an empty field."""
    if _missing(v):
        return "0.0" if fill_zero else ""
    return str(int(v)) if kind == "int" else repr(float(v))


def write_rows_csv(rows: Sequence[dict], path: str) -> None:
    """``pd.DataFrame(rows).fillna(0).to_csv(path, index=False)``: columns
    in the order they first appear across rows; a column missing from a row
    (or NaN there) becomes float and reads 0.0, an integer column without
    gaps stays integer, floats print in Python's shortest repr."""
    columns: Dict[str, None] = {}
    for r in rows:
        for k in r:
            columns.setdefault(k)
    cols = list(columns)
    kinds = {c: _kind([r.get(c) for r in rows]) for c in cols}
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([_cell(r.get(c), kinds[c], True) for c in cols])


def main(argv=None) -> dict:
    """Run the evaluation; returns {"out_dir", "num_mols", "empty_rows"
    (family -> row indices), "load_s" (reading or making the molecules),
    "similarity_s" (making the reference sets and comparing with them),
    "seconds" (all of it)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--from_where", choices=["generated", "dataset", "smiles"],
                    default="generated")
    ap.add_argument("--root", default=None, help="generated samples dir")
    ap.add_argument("--dataset_root", default=None)
    ap.add_argument("--split", default="test")
    ap.add_argument("--corpus_mols", type=int, default=None,
                    help="when --dataset_root is a corpus recipe and no directory: make only "
                         "the first N molecules of it (default: all of it) before splitting")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--parallel", action="store_true")
    ap.add_argument("--global3d", action="store_true",
                    help="also compute the (slow) re-embedding RMSD family")
    ap.add_argument("--force", action="store_true",
                    help="recompute even if mols.csv already exists "
                         "(the reference caches dataset-split metrics)")
    args = ap.parse_args(argv)
    t0 = time.time()

    if args.from_where == "generated":
        assert args.root, "--root required for generated"
        out_dir = args.outdir or os.path.join(args.root, "metrics")
        mols, decoded = load_generated(args.root)
    elif args.from_where == "smiles":
        assert args.root, "--root (SMILES file) required for smiles"
        out_dir = args.outdir or os.path.join(
            os.path.dirname(os.path.abspath(args.root)), "metrics_smiles"
        )
        mols, n_skipped = load_smiles_file(args.root, args.limit)
        decoded = []
    else:
        assert args.dataset_root, "--dataset_root required for dataset"
        out_dir = args.outdir or os.path.join(
            args.dataset_root, "metrics", args.split
        )
        if not args.force and os.path.exists(os.path.join(out_dir, "mols.csv")):
            get_logger(LOGGER, out_dir).info(
                f"cached metrics exist at {out_dir} (use --force to redo)")
            return {"out_dir": out_dir, "num_mols": 0, "empty_rows": {}, "load_s": 0.0,
                    "similarity_s": 0.0, "seconds": 0.0}
        mols = load_dataset_mols(args.dataset_root, args.split, args.limit, args.corpus_mols)
        decoded = []
    t_loaded = time.time()
    os.makedirs(out_dir, exist_ok=True)
    logger = get_logger(LOGGER, out_dir)
    logger.info(f"evaluating {len(mols)} molecules -> {out_dir}")
    # a missing SA table raises here, before get_metric could turn it into
    # empty rows
    _default_scorer()

    # per-mol metrics
    families = list(FAMILIES)
    if args.global3d and args.from_where != "smiles":
        families.append("global_3d")
    rows, empty = score_rows(mols, families, parallel=args.parallel)
    write_rows_csv(rows, os.path.join(out_dir, "mols.csv"))
    logger.info(f"mols.csv: ({len(rows)}, {len({k for r in rows for k in r})})")
    for family, idx in empty.items():
        logger.info(f"{family}: {len(idx)} empty rows {idx}")
    report = {"out_dir": out_dir, "num_mols": len(mols), "empty_rows": empty,
              "load_s": t_loaded - t0, "similarity_s": 0.0}

    # local 3d distributions (needs conformers; SMILES input has none)
    if args.from_where == "smiles":
        with open(os.path.join(out_dir, "local3d.pkl"), "wb") as f:
            pickle.dump(None, f)
        rings, counts = RingAnalyzer().get_freq_rings(mols, topk=10)
        with open(os.path.join(out_dir, "freq_ring_type.pkl"), "wb") as f:
            pickle.dump({"rings": rings, "counts": counts}, f)
        logger.info(f"top rings: {list(zip(rings, counts))[:5]}")
        return dict(report, seconds=time.time() - t0)
    l3d = Local3D()
    l3d.get_predefined()
    local3d = {
        "length": l3d.calc_frequent(mols, "length"),
        "angle": l3d.calc_frequent(mols, "angle"),
        "dihedral": l3d.calc_frequent(mols, "dihedral"),
    }
    with open(os.path.join(out_dir, "local3d.pkl"), "wb") as f:
        pickle.dump(local3d, f)

    # validity (generated only: needs raw decoded outputs incl. failures),
    # under the acceptance of the run that produced the pool (summary.json's
    # sanitize_mode), or validity.json disagrees with summary.json
    if decoded:
        sanitize_mode = "reference"
        summary_path = os.path.join(args.root, "summary.json")
        if os.path.exists(summary_path):
            with open(summary_path) as f:
                sanitize_mode = json.load(f).get(
                    "sanitize_mode", sanitize_mode) or sanitize_mode
        validity = calculate_validity(decoded, sanitize_mode=sanitize_mode)
        with open(os.path.join(out_dir, "validity.json"), "w") as f:
            json.dump(validity, f, indent=2)
        logger.info(f"validity: {validity}")

    # similarity vs train/val (needs dataset root)
    if args.dataset_root and args.from_where == "generated":
        t_sim = time.time()
        train = load_dataset_mols(args.dataset_root, "train", args.limit, args.corpus_mols)
        val = load_dataset_mols(args.dataset_root, "val", args.limit, args.corpus_mols)
        sim = SimilarityAnalysis(train_mols=train, val_mols=val)
        simm = sim.all_metrics(mols)
        with open(os.path.join(out_dir, "similarity.json"), "w") as f:
            json.dump(simm, f, indent=2)
        logger.info(f"similarity: {simm}")
        report["similarity_s"] = time.time() - t_sim

    # frequent ring types
    rings, counts = RingAnalyzer().get_freq_rings(mols, topk=10)
    with open(os.path.join(out_dir, "freq_ring_type.pkl"), "wb") as f:
        pickle.dump({"rings": rings, "counts": counts}, f)
    logger.info(f"top rings: {list(zip(rings, counts))[:5]}")
    return dict(report, seconds=time.time() - t0)


if __name__ == "__main__":
    main()
