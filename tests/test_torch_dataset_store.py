"""The port's SDF-directory data path against the JAX package's:
make_synthetic_dataset writes the same directory; Drug3DDataset packs the
same store bytes, serially and through its spawn pool; get_dataset gives the
same subsets from a .pkl and a .pt split; the summary CSV's filters read as
pandas reads them; the loader's first batch over the subsets is JAX's; and
the LMDB migration (tests/test_convert_lmdb.py's cases) writes JAX's
store."""
import filecmp
import multiprocessing
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from moldiff_tpu.data import convert_lmdb as jcv
from moldiff_tpu.data import dataset as jdataset
from moldiff_tpu.data.featurize import MolFeaturizer as JFeaturizer
from moldiff_tpu.data.loader import BucketedLoader as JLoader
from moldiff_tpu.data.synthetic import make_synthetic_dataset as j_make_synthetic_dataset
from moldiff_tpu_torch.data import convert_lmdb as tcv
from moldiff_tpu_torch.data import dataset as tdataset
from moldiff_tpu_torch.data.featurize import MolFeaturizer
from moldiff_tpu_torch.data.loader import BucketedLoader
from moldiff_tpu_torch.data.record_store import RecordReader
from moldiff_tpu_torch.data.synthetic import make_synthetic_dataset

PATH_DICT = {"sdf": "sdf", "summary": "mol_summary.csv", "processed": "processed.mdb"}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


def _same_store(a, b):
    for ext in (".bin", ".idx"):
        assert filecmp.cmp(a + ext, b + ext, shallow=False), ext


@pytest.fixture
def jax_serial(monkeypatch):
    """The JAX package's _process on one worker (its pool forks, which a
    process running JAX's threads should not do)."""
    monkeypatch.setattr(multiprocessing, "cpu_count", lambda: 1)


@pytest.mark.parametrize("chemistry,n_confs", [("v1", 1), ("v1", 2), ("v2", 1), ("v2", 2)])
def test_synthetic_directory_and_store_equal_jax(tmp_path, jax_serial, chemistry, n_confs):
    """20 molecules: the directories are equal file for file, and the
    stores each package packs from it (the port's native parser, its Python
    parser, JAX's) equal byte for byte."""
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    make_synthetic_dataset(port, n_mols=20, seed=5, n_confs=n_confs, chemistry=chemistry)
    j_make_synthetic_dataset(jax, n_mols=20, seed=5, n_confs=n_confs, chemistry=chemistry)
    _same_tree(port, jax)
    ds = tdataset.Drug3DDataset(port, PATH_DICT)
    jdataset.Drug3DDataset(jax, PATH_DICT)
    _same_store(ds.store_path, os.path.join(jax, "processed"))
    assert len(ds) == 20 and ds[0]["pos"].shape[0] == n_confs
    py = str(tmp_path / "py")
    make_synthetic_dataset(py, n_mols=20, seed=5, n_confs=n_confs, chemistry=chemistry)
    tdataset.Drug3DDataset(py, PATH_DICT, parser="python")
    _same_store(os.path.join(py, "processed"), ds.store_path)


def test_pooled_store_equals_serial_and_jax(tmp_path, jax_serial):
    """Above 64 molecules the port parses in a spawn pool; its store is the
    serial path's and JAX's byte for byte."""
    root = str(tmp_path / "d")
    make_synthetic_dataset(root, n_mols=70, seed=11, chemistry="v1")
    jdataset.Drug3DDataset(root, dict(PATH_DICT, processed="jax.mdb"))
    serial = tdataset.Drug3DDataset(root, dict(PATH_DICT, processed="serial.mdb"))
    pooled = tdataset.Drug3DDataset.__new__(tdataset.Drug3DDataset)
    pooled.__dict__.update(serial.__dict__, store_path=os.path.join(root, "pooled"))
    assert pooled._process(n_workers=2) == (70, 0)
    _same_store(os.path.join(root, "pooled"), serial.store_path)
    _same_store(serial.store_path, os.path.join(root, "jax"))


def _split_files(root):
    with open(os.path.join(root, "split_by_molid.pkl"), "rb") as f:
        split = pickle.load(f)
    torch.save(split, os.path.join(root, "split_by_molid.pt"))


@pytest.mark.parametrize("split", ["split_by_molid.pkl", "split_by_molid.pt"])
def test_get_dataset_subsets_equal_jax(tmp_path, jax_serial, split):
    root = str(tmp_path / "d")
    make_synthetic_dataset(root, n_mols=30, seed=2, chemistry="v2")
    _split_files(root)
    cfg = {"root": root, "path_dict": PATH_DICT, "split": split}
    ds, subsets = tdataset.get_dataset(cfg)
    jds, jsubsets = jdataset.get_dataset(cfg)
    assert sorted(subsets) == sorted(jsubsets) == ["test", "train", "val"]
    for name in subsets:
        assert subsets[name].indices == jsubsets[name].indices
        got = [subsets[name][i] for i in range(len(subsets[name]))]
        want = [jsubsets[name][i] for i in range(len(jsubsets[name]))]
        assert [r["molid"] for r in got] == [r["molid"] for r in want]
        for a, b in zip(got, want):
            assert pickle.dumps(a) == pickle.dumps(b)
    assert ds.molid2idx == jds.molid2idx
    # no split file: every record in "train"
    _, only = tdataset.get_dataset({"root": root, "path_dict": PATH_DICT})
    assert list(only) == ["train"] and only["train"].indices == list(range(30))


SUMMARIES = {
    "bool": ("molid,pass_size,pass_element,broken,error_mol\n"
             "a,True,True,False,False\nb,False,True,False,False\nc,True,True,True,False\n"
             "d,True,True,False,False\ne,True,False,False,False\n"),
    "int": ("molid,pass_size,broken\n"
            "a,1,0\nb,0,0\nc,1,1\nd,1,0\ne,1,0\n"),
    "missing_cells": ("molid,pass_size,broken\n"
                      "a,True,False\nb,False,False\nc,True,\nd,,False\ne,True,False\n"),
    "first_column_id": ("name,broken,error_mol\n"
                        "a,0,0\nb,0.0,1\nc,2,0\nd,0,0\ne,0,0\n"),
}


@pytest.mark.parametrize("kind", sorted(SUMMARIES) + ["numeric_ids", "no_csv"])
def test_summary_filter_reads_like_pandas(tmp_path, jax_serial, kind):
    """The molids that pass the reference filters (pass_size,
    pass_element, not broken, not error_mol), in True/False and 0/1 forms,
    with missing cells, the id in the first column, numeric ids, and
    without a CSV (every *.sdf, sorted) are JAX's (pandas') in its order."""
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    for root in (port, jax):
        make_synthetic_dataset(root, n_mols=5, seed=4, chemistry="v1")
        names = ["syn00000", "syn00001", "syn00002", "syn00003", "syn00004"]
        ids = ["3", "10", "2", "7", "5"] if kind == "numeric_ids" else list("abcde")
        for old, new in zip(names, ids):
            os.rename(os.path.join(root, "sdf", f"{old}.sdf"),
                      os.path.join(root, "sdf", f"{new}.sdf"))
        csv_path = os.path.join(root, "mol_summary.csv")
        if kind == "no_csv":
            os.remove(csv_path)
        else:
            text = SUMMARIES.get(kind, SUMMARIES["int"])
            for a, b in zip("abcde", ids):
                text = text.replace(f"\n{a},", f"\n{b},")
            with open(csv_path, "w") as f:
                f.write(text)
    ds = tdataset.Drug3DDataset(port, PATH_DICT)
    jds = jdataset.Drug3DDataset(jax, PATH_DICT)
    got = [ds[i]["molid"] for i in range(len(ds))]
    assert got == [jds[i]["molid"] for i in range(len(jds))]
    assert [type(m) for m in got] == [type(jds[i]["molid"]) for i in range(len(jds))]
    _same_store(ds.store_path, jds.store_path)
    if kind in ("bool", "int"):
        assert got == ["a", "d"] + (["e"] if kind == "int" else [])


def test_interrupted_processing_processes_again(tmp_path, monkeypatch):
    """A _process cut short (here by an interrupt at the fifth molecule)
    leaves no store, so the next Drug3DDataset processes the directory
    again instead of reading a truncated store."""
    root = str(tmp_path / "d")
    make_synthetic_dataset(root, n_mols=20, seed=5, chemistry="v2")
    parse, calls = tdataset._parse_one, []

    def interrupted(*a):
        calls.append(a)
        if len(calls) == 5:
            raise KeyboardInterrupt
        return parse(*a)

    monkeypatch.setattr(tdataset, "_parse_one", interrupted)
    with pytest.raises(KeyboardInterrupt):
        tdataset.Drug3DDataset(root, PATH_DICT, parser="python")
    assert not [f for f in os.listdir(root) if f.startswith("processed")]
    monkeypatch.setattr(tdataset, "_parse_one", parse)
    ds = tdataset.Drug3DDataset(root, PATH_DICT, parser="python")
    assert len(ds) == 20


def test_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="record store"):
        tdataset.Drug3DDataset(str(tmp_path), PATH_DICT)
    with pytest.raises(ValueError, match="parser"):
        tdataset.Drug3DDataset(str(tmp_path), PATH_DICT, parser="rdkit")


def test_first_loader_batch_equals_jax(tmp_path, jax_serial):
    root = str(tmp_path / "d")
    make_synthetic_dataset(root, n_mols=30, seed=9, chemistry="v2")
    cfg = {"root": root, "path_dict": PATH_DICT, "split": "split_by_molid.pkl"}
    _, subsets = tdataset.get_dataset(cfg)
    _, jsubsets = jdataset.get_dataset(cfg)
    kw = dict(atomic_numbers=(6, 7, 8, 9, 15, 16, 17), mol_bond_types=(1, 2, 3, 4),
              use_mask_node=True, use_mask_edge=True)
    got = next(iter(BucketedLoader(subsets["train"], MolFeaturizer(**kw), 4, (24, 32, 48),
                                   seed=3, prefetch=0)))
    want = next(iter(JLoader(jsubsets["train"], JFeaturizer(**kw), 4, (24, 32, 48), seed=3,
                             prefetch=0)))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# -- the LMDB migration (tests/test_convert_lmdb.py's cases) -----------------

def _directed_bonds(n, bonds):
    row, col, types_ = [], [], []
    for i, j, t in bonds:
        row += [i, j]
        col += [j, i]
        types_ += [t, t]
    bi = np.array([row, col], dtype=np.int64)
    bt = np.array(types_, dtype=np.int64)
    perm = (bi[0] * n + bi[1]).argsort()
    return bi[:, perm], bt[perm]


def _fake_record(layout: str, seed: int):
    """A pickled reference LMDB value (PyG 1.x attributes in __dict__, or
    2.x in _store._mapping)."""
    tcv.install_unpickle_stubs()
    import utils.data as ref_data

    n = 4
    bi, bt = _directed_bonds(n, [(0, 1, 1), (1, 2, 2), (2, 3, 1)])
    g = torch.Generator().manual_seed(seed)
    payload = {"element": torch.tensor([6, 6, 7, 8]), "pos_all_confs": torch.randn(2, n, 3,
                                                                                   generator=g),
               "bond_index": torch.from_numpy(bi), "bond_type": torch.from_numpy(bt),
               "num_atoms": n, "num_confs": 2}
    obj = ref_data.Drug3DData.__new__(ref_data.Drug3DData)
    if layout == "pyg1":
        obj.__dict__.update(payload)
    else:
        store = tcv._StubStorage()
        store.__dict__["_mapping"] = payload
        obj.__dict__["_store"] = store
    return pickle.dumps(obj)


@pytest.mark.parametrize("layout", ["pyg1", "pyg2"])
def test_convert_items_equal_jax(tmp_path, layout):
    items = [(f"mol{k}".encode(), _fake_record(layout, k)) for k in range(3)]
    items.append((b"bad", b"not a pickle"))
    assert tcv.convert_items(items, str(tmp_path / "port")) == (3, 1)
    assert jcv.convert_items(items, str(tmp_path / "jax")) == (3, 1)
    _same_store(str(tmp_path / "port"), str(tmp_path / "jax"))
    with RecordReader(str(tmp_path / "port")) as r:
        rec = r[0]
    assert rec["molid"] == "mol0" and rec["pos"].shape == (2, 4, 3)
    np.testing.assert_array_equal(rec["bond_index"], [[0, 1, 2], [1, 2, 3]])
    np.testing.assert_array_equal(rec["bond_type"], [1, 2, 1])


def test_convert_lmdb_gated_and_split_files(tmp_path):
    import importlib.util

    if "lmdb" not in sys.modules and importlib.util.find_spec("lmdb") is None:
        with pytest.raises(ImportError, match="lmdb"):
            tcv.convert_lmdb("/nonexistent.lmdb", str(tmp_path / "p"))
    split = {"train": ["a", "b"], "val": ["c"], "test": ["d"]}
    torch.save(split, str(tmp_path / "s.pt"))
    with open(tmp_path / "s.pkl", "wb") as f:
        pickle.dump(split, f)
    for name in ("s.pt", "s.pkl"):
        assert tcv.load_reference_split(str(tmp_path / name)) == split \
            == jcv.load_reference_split(str(tmp_path / name))


def test_converted_store_plugs_into_get_dataset(tmp_path):
    items = [(f"m{k}".encode(), _fake_record("pyg2", k)) for k in range(5)]
    tcv.convert_items(items, str(tmp_path / "processed"))
    torch.save({"train": ["m0", "m1", "m2"], "val": ["m3"], "test": ["m4"]},
               str(tmp_path / "split_by_molid.pt"))
    cfg = {"root": str(tmp_path), "path_dict": {"processed": "processed.mdb"},
           "split": "split_by_molid.pt"}
    ds, subsets = tdataset.get_dataset(cfg)
    jds, jsubsets = jdataset.get_dataset(cfg)
    assert len(ds) == len(jds) == 5
    assert {k: v.indices for k, v in subsets.items()} == {k: v.indices for k, v in jsubsets.items()}
    assert subsets["val"][0]["molid"] == "m3"


def test_eval_reads_the_store_like_jax(tmp_path, jax_serial):
    """--from_where dataset on a dataset directory: the port reads the
    split from the store and gives scripts/evaluate_all.py's molecules."""
    from moldiff_tpu.chem.smiles import mol_to_smiles as jsmiles
    from moldiff_tpu_torch.chem.smiles import mol_to_smiles
    from moldiff_tpu_torch.eval.evaluate import load_dataset_mols
    from scripts.evaluate_all import load_dataset_mols as j_load_dataset_mols

    root = str(tmp_path / "d")
    make_synthetic_dataset(root, n_mols=30, seed=12, chemistry="v2")
    for split in ("train", "test"):
        got = load_dataset_mols(root, split)
        want = j_load_dataset_mols(root, split)
        assert len(got) == len(want) > 0
        assert [mol_to_smiles(m) for m in got] == [jsmiles(m) for m in want]
        assert [[a.pos.tolist() for a in m.atoms] for m in got] == \
            [[a.pos.tolist() for a in m.atoms] for m in want]
