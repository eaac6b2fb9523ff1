"""ctypes binding for the port's native SDF parser (native/sdf_parser.cpp;
moldiff_tpu/chem/sdf_native.py's interface).

The dataset's ingestion loop (data/dataset.py) parses each molecule's SDF
file with it. It gives what the Python parser (chem/sdf.py) gives: one
entry per ``$$$$`` record, ``None`` for a record that does not parse
(tests/test_torch_sdf_native.py holds the two, and the JAX package's
parser, equal).

The library is compiled with the host's C++ compiler (``$CXX``, else
``c++`` or ``g++`` on ``PATH``) at first use, into
``build/native/<hash of the source and flags>/libsdf_parser.so`` at the
root of the checkout; a finished build is reused. The compiler writes into
a temporary directory and the library is renamed into place, so processes
that build at once each see a whole file. A build that fails raises with
the compiler's output; nothing falls back to the Python parser. Nothing
builds at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

from .mol import Mol

SOURCE = Path(__file__).resolve().parent.parent / "native" / "sdf_parser.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native"
LIB_NAME = "libsdf_parser.so"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
COMPILE_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)
# exported C functions: name -> (argument types, return type)
SIGNATURES = {
    "sdf_parse_file": ([ctypes.c_char_p], _P),
    "sdf_num_mols": ([_P], ctypes.c_int64),
    "sdf_totals": ([_P, _I64P, _I64P], None),
    "sdf_fill_all": ([_P, _I64P, _I64P, _I32P, _F64P, _I32P, _I32P], ctypes.c_int),
    "sdf_free": ([_P], None),
}

_loaded: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def find_cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler: set $CXX or put c++ or g++ on PATH")


def native_available() -> bool:
    """Whether the parser is built or a C++ compiler is there to build it
    (a build that then fails still raises)."""
    if _loaded is not None or lib_path().exists():
        return True
    try:
        find_cxx()
    except RuntimeError:
        return False
    return True


def build() -> Path:
    """Compile the parser unless this version of the source is built;
    return the library's path."""
    lib = lib_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    cxx = find_cxx()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        tmp_lib = os.path.join(tmp, LIB_NAME)
        cmd = [cxx, *CXX_FLAGS, "-o", tmp_lib, str(SOURCE)]
        try:
            done = subprocess.run(cmd, timeout=COMPILE_TIMEOUT_S, capture_output=True, text=True)
        except subprocess.TimeoutExpired as exc:
            raise RuntimeError(f"the SDF parser's build did not finish within "
                               f"{COMPILE_TIMEOUT_S} s") from exc
        if done.returncode != 0:
            raise RuntimeError(f"SDF parser build failed:\n$ {' '.join(cmd)}\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded parser library, built first if needed."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded = lib
    return _loaded


def _parse_batch(path: str):
    """One native parse and one fill of the whole file: per record a
    ``(z, pos [n, 3] f64, charge, bonds [m, 3])`` tuple, or None for a
    record that does not parse."""
    lib = library()
    h = lib.sdf_parse_file(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        n_mols = int(lib.sdf_num_mols(h))
        ta, tb = ctypes.c_int64(), ctypes.c_int64()
        lib.sdf_totals(h, ctypes.byref(ta), ctypes.byref(tb))
        n_atoms = np.empty(n_mols, np.int64)
        n_bonds = np.empty(n_mols, np.int64)
        z = np.empty(max(ta.value, 1), np.int32)
        pos = np.empty(max(3 * ta.value, 1), np.float64)
        charge = np.empty(max(ta.value, 1), np.int32)
        bonds = np.empty(max(3 * tb.value, 1), np.int32)
        rc = lib.sdf_fill_all(h, n_atoms.ctypes.data_as(_I64P), n_bonds.ctypes.data_as(_I64P),
                              z.ctypes.data_as(_I32P), pos.ctypes.data_as(_F64P),
                              charge.ctypes.data_as(_I32P), bonds.ctypes.data_as(_I32P))
        if rc != 0:
            raise RuntimeError(f"sdf_fill_all rc={rc}")
    finally:
        lib.sdf_free(h)

    out = []
    za = ba = 0
    pos3 = pos.reshape(-1, 3)
    bonds3 = bonds.reshape(-1, 3)
    for i in range(n_mols):
        if n_atoms[i] < 0:
            out.append(None)
            continue
        n, m = int(n_atoms[i]), int(n_bonds[i])
        out.append((z[za:za + n], pos3[za:za + n], charge[za:za + n], bonds3[ba:ba + m]))
        za += n
        ba += m
    return out


def read_sdf_native(path: str) -> List[Optional[Mol]]:
    """A whole .sdf file, parsed natively, as Mol objects (None where a
    record does not parse or its bonds are invalid)."""
    out: List[Optional[Mol]] = []
    for rec in _parse_batch(path):
        if rec is None:
            out.append(None)
            continue
        z, pos3, charge, bonds3 = rec
        mol = Mol()
        for a in range(len(z)):
            mol.add_atom(int(z[a]), pos=tuple(pos3[a]))
            if charge[a]:
                mol.atoms[a].charge = int(charge[a])
        try:
            for i, j, o in bonds3:
                mol.add_bond(int(i), int(j), int(o))
        except Exception:
            out.append(None)  # bad bond indices, like molblock_to_mol
            continue
        out.append(mol)
    return out


def read_sdf_arrays(path: str) -> List[Optional[dict]]:
    """The ingestion path: text -> record arrays without Mol objects. Each
    entry is {element int16 [n], pos float32 [n, 3], bond_index int16
    [2, m] (i < j, sorted by i * n + j), bond_type int8 [m]}, or None for a
    record that does not parse or whose bonds Mol.add_bond would refuse
    (out of range, a self bond, a duplicate, an order outside 1-4)."""
    out: List[Optional[dict]] = []
    for rec in _parse_batch(path):
        if rec is None:
            out.append(None)
            continue
        z, pos3, _charge, bonds3 = rec
        n = len(z)
        if len(bonds3):
            i = bonds3[:, 0].astype(np.int64)
            j = bonds3[:, 1].astype(np.int64)
            bt_raw = bonds3[:, 2].astype(np.int64)
            if (((i < 0) | (j < 0) | (i >= n) | (j >= n) | (i == j)).any()
                    or (~np.isin(bt_raw, (1, 2, 3, 4))).any()):
                out.append(None)
                continue
            lo, hi = np.minimum(i, j), np.maximum(i, j)
            flat = lo * n + hi
            if len(np.unique(flat)) != len(flat):
                out.append(None)
                continue
            order = np.argsort(flat, kind="stable")
            bi = np.stack([lo[order], hi[order]]).astype(np.int16)
            bt = bt_raw[order].astype(np.int8)
        else:
            bi = np.zeros((2, 0), np.int16)
            bt = np.zeros((0,), np.int8)
        out.append({"element": z.astype(np.int16), "pos": pos3.astype(np.float32),
                    "bond_index": bi, "bond_type": bt})
    return out
