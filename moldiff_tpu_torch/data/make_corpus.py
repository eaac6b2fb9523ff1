"""Generate a synthetic training corpus as an SDF directory and pack its
record store (scripts/make_corpus.py for the port).

  python -m moldiff_tpu_torch.data.make_corpus xl2          # ./data/synthetic_xl2
  python -m moldiff_tpu_torch.data.make_corpus demo full2   # several
  python -m moldiff_tpu_torch.data.make_corpus all

Each corpus is data/dataset.py's CORPORA recipe (one seeded stream, so the
directory is the JAX script's byte for byte): sdf/<molid>.sdf,
mol_summary.csv and split_by_molid.pkl under its root, then the record
store (processed.bin / .idx) built by the native parser, so that training
(``dataset.root`` of a train config) starts without a processing pause. A
root that already holds mol_summary.csv is not generated again.
"""
from __future__ import annotations

import argparse
import os
import time

from .dataset import CORPORA, DEFAULT_PATH_DICT, Drug3DDataset
from .synthetic import make_synthetic_dataset

# scripts/make_corpus.py's names for the CORPORA roots
NAMES = {"demo": "./data/synthetic", "full": "./data/synthetic_full",
         "xl": "./data/synthetic_xl", "full2": "./data/synthetic_full2",
         "xl2": "./data/synthetic_xl2"}


def build(name: str, log=print) -> Drug3DDataset:
    root = NAMES[name]
    n_mols, seed, chemistry = CORPORA[root]
    t0 = time.time()
    if os.path.exists(os.path.join(root, DEFAULT_PATH_DICT["summary"])):
        log(f"[{name}] {root} exists, skipping generation")
    else:
        log(f"[{name}] generating {n_mols} molecules (seed {seed}, {chemistry}) -> {root}")
        make_synthetic_dataset(root, n_mols=n_mols, seed=seed, chemistry=chemistry)
        log(f"[{name}] generated in {time.time() - t0:.0f}s")
    t1 = time.time()
    ds = Drug3DDataset(root)
    log(f"[{name}] record store ready: {len(ds)} records ({time.time() - t1:.0f}s)")
    return ds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("corpus", nargs="+", choices=sorted(NAMES) + ["all"])
    args = ap.parse_args(argv)
    for name in sorted(NAMES) if "all" in args.corpus else args.corpus:
        build(name)


if __name__ == "__main__":
    main()
