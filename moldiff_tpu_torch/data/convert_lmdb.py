"""Migrate a reference-processed LMDB dataset into the record store (a copy
of moldiff_tpu/data/convert_lmdb.py).

Users of the reference keep their GEOM-Drug corpus as an LMDB of pickled
``Drug3DData`` objects (reference utils/dataset.py:117-128, values written
by ``parse_conf_list``, utils/parser.py:16-68). This module reads those
records without torch_geometric (stub classes stand in for the PyG
``Data`` and storage types while unpickling) and writes the record store
(data/record_store.py) in the schema of data/dataset.py.

The ``lmdb`` binding is needed only to read the source file and is
imported inside :func:`convert_lmdb`; the stubs, the record conversion and
the store writing work without it.
"""
from __future__ import annotations

import os
import pickle
import sys
import types
from typing import Iterable, Optional, Tuple

import numpy as np

from .record_store import RecordWriter


# ---------------------------------------------------------------------------
# unpickle stubs: resolve the reference's class paths without PyG installed
# ---------------------------------------------------------------------------

class _StubStorage:
    """Stands in for torch_geometric.data.storage.* during unpickling; any
    pickled state is absorbed into __dict__."""

    def __init__(self, *a, **kw):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _StubData(_StubStorage):
    """Stands in for torch_geometric.data.Data / utils.data.Drug3DData."""


_STUB_CLASSES = {
    # module path -> class names to provide
    "utils.data": ("Drug3DData",),
    "torch_geometric.data": ("Data", "Batch"),
    "torch_geometric.data.data": ("Data", "DataEdgeAttr", "DataTensorAttr"),
    "torch_geometric.data.storage": (
        "GlobalStorage", "NodeStorage", "EdgeStorage", "BaseStorage",
    ),
}


def install_unpickle_stubs() -> None:
    """Register stub modules so pickles referencing the reference's class
    paths load as plain attribute bags. Real installed modules win: a stub
    is only installed when the import fails."""
    for mod_path, names in _STUB_CLASSES.items():
        try:
            __import__(mod_path)
            continue
        except Exception:
            pass
        parts = mod_path.split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name not in sys.modules:
                sys.modules[name] = types.ModuleType(name)
        mod = sys.modules[mod_path]
        base = _StubData if mod_path == "utils.data" else (
            _StubData if names[0] in ("Data", "Batch") else _StubStorage
        )
        for cls_name in names:
            if not hasattr(mod, cls_name):
                cls = type(cls_name, (base,),
                           {"__module__": mod_path, "__qualname__": cls_name})
                setattr(mod, cls_name, cls)


# ---------------------------------------------------------------------------
# record extraction
# ---------------------------------------------------------------------------

def _to_numpy(v):
    if hasattr(v, "detach"):  # torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _attr(obj, key):
    """Fetch ``key`` from a real PyG Data, a stub-unpickled bag, or a dict.

    PyG 1.x keeps attributes in __dict__; PyG 2.x nests them in
    _store._mapping. Stubs absorb either layout into __dict__.
    """
    if isinstance(obj, dict):
        return obj.get(key)
    d = getattr(obj, "__dict__", {})
    if key in d:
        return d[key]
    store = d.get("_store")
    if store is not None:
        sd = getattr(store, "__dict__", {})
        if key in sd:
            return sd[key]
        mapping = sd.get("_mapping")
        if isinstance(mapping, dict) and key in mapping:
            return mapping[key]
    # real PyG objects support attribute access directly
    try:
        return getattr(obj, key)
    except Exception:
        return None


def record_from_reference(obj, molid=None) -> Optional[dict]:
    """Reference Drug3DData (or raw parse dict) -> framework record schema
    {molid, element int16, pos [n_confs,n,3] f32, bond_index [2,nb] i<j
    sorted by flat index, bond_type [nb]} (data/dataset.py:parse_conf_list).

    The reference stores DIRECTED duplicated bonds (both (i,j) and (j,i),
    utils/parser.py:88-98); we keep each undirected bond once with i < j.
    """
    element = _attr(obj, "element")
    if element is None:
        return None
    element = _to_numpy(element).astype(np.int16)
    pos = _attr(obj, "pos_all_confs")
    if pos is None:
        pos = _attr(obj, "pos")
    pos = _to_numpy(pos).astype(np.float32)
    if pos.ndim == 2:
        pos = pos[None]
    n = int(element.shape[0])
    if pos.shape[-2] != n:
        return None

    bond_index = _attr(obj, "bond_index")
    bond_type = _attr(obj, "bond_type")
    if bond_index is None or bond_type is None:
        bi = np.zeros((2, 0), np.int16)
        bt = np.zeros((0,), np.int8)
    else:
        bond_index = _to_numpy(bond_index).astype(np.int64)
        bond_type = _to_numpy(bond_type).astype(np.int64)
        keep = bond_index[0] < bond_index[1]  # one direction per bond
        pairs = bond_index[:, keep]
        types_ = bond_type[keep]
        order = np.argsort(pairs[0] * n + pairs[1], kind="stable")
        bi = pairs[:, order].astype(np.int16)
        bt = types_[order].astype(np.int8)

    if molid is None:
        molid = _attr(obj, "molid")
    return {
        "molid": molid,
        "element": element,
        "pos": pos,
        "bond_index": bi,
        "bond_type": bt,
    }


# ---------------------------------------------------------------------------
# conversion entry points
# ---------------------------------------------------------------------------

def convert_items(
    items: Iterable[Tuple[bytes, bytes]],
    store_path: str,
    log_every: int = 10000,
    logger=None,
) -> Tuple[int, int]:
    """(key, pickled-value) pairs -> record store at ``store_path``.

    Keys become molids (utf-8 decoded). Returns (n_ok, n_skipped).
    """
    install_unpickle_stubs()
    n_ok = n_bad = 0
    os.makedirs(os.path.dirname(os.path.abspath(store_path)), exist_ok=True)
    with RecordWriter(store_path) as w:
        for key, raw in items:
            try:
                obj = pickle.loads(raw)
                molid = key.decode() if isinstance(key, bytes) else str(key)
                rec = record_from_reference(obj, molid=molid)
            except Exception:
                rec = None
            if rec is None:
                n_bad += 1
            else:
                w.append(rec)
                n_ok += 1
            if logger and log_every and (n_ok + n_bad) % log_every == 0:
                logger.info(f"converted {n_ok} records ({n_bad} skipped)")
    return n_ok, n_bad


def convert_lmdb(lmdb_path: str, store_path: str, logger=None) -> Tuple[int, int]:
    """Read a reference processed.lmdb and write the record store.

    Requires the ``lmdb`` python binding (present wherever the reference
    pipeline ran; not shipped in this image — the call is gated)."""
    try:
        import lmdb  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the 'lmdb' package is required to read the reference LMDB; "
            "run this converter in the environment that produced the file "
            "(or regenerate from SDFs, which needs no LMDB)"
        ) from e

    env = lmdb.open(
        lmdb_path, map_size=10 * 1024 ** 3, create=False, subdir=False,
        readonly=True, lock=False, readahead=True, meminit=False,
    )
    try:
        with env.begin() as txn:
            return convert_items(txn.cursor(), store_path, logger=logger)
    finally:
        env.close()


def load_reference_split(path: str) -> dict:
    """Load a split file: pickle ({split: [molid]}) or the reference's
    torch.save'd split_by_molid.pt."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        import torch

        return torch.load(path, map_location="cpu", weights_only=False)
