"""The packed record store (moldiff_tpu/data/record_store.py's format).

A store at ``path`` is two files: ``path.bin``, an 8-byte little-endian
magic followed by the records' bytes back to back, and ``path.idx``, the
magic, the record count and one little-endian ``(offset, length)`` uint64
pair per record. A record is usually a pickled molecule dict
(data/dataset.py); ``append_bytes`` / ``get_bytes`` take raw bytes.

The JAX package reads it through a C++ library with a pure-Python
fallback; here it is pure Python: the data file is mmapped and the index
read once with ``np.frombuffer``, so ``get_bytes`` is one slice of the map.
A store written by either package reads in the other, and the bytes are
the same for the same records.
"""
from __future__ import annotations

import mmap
import os
import pickle
import struct
from typing import Any, Iterator

import numpy as np

MAGIC = 0x4D4F4C4452454331


def _paths(path: str):
    return path + ".bin", path + ".idx"


def using_native() -> bool:
    """Whether a native library serves the store: never in the port (the
    JAX package's C++ store has no counterpart; the mmap reader is
    zero-copy already)."""
    return False


class RecordWriter:
    """Append-only record writer. ``append(obj)`` pickles; ``append_bytes``
    stores raw bytes. Both files are written under temporary names and
    renamed into place by ``close``, the index last, so a store whose
    ``.idx`` exists is whole. Leaving a ``with`` block on an exception
    removes them instead: an interrupted write leaves no store behind."""

    def __init__(self, path: str):
        self._paths = _paths(path)
        tag = f".{os.getpid()}.{id(self):x}.tmp"
        self._tmp = tuple(p + tag for p in self._paths)
        os.makedirs(os.path.dirname(os.path.abspath(self._paths[0])), exist_ok=True)
        self._f = open(self._tmp[0], "wb")
        self._f.write(struct.pack("<Q", MAGIC))
        self._off = 8
        self._index = []

    def append_bytes(self, b: bytes) -> int:
        self._f.write(b)
        self._index.append((self._off, len(b)))
        self._off += len(b)
        return len(self._index) - 1

    def append(self, obj: Any) -> int:
        return self.append_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.close()
        index = np.asarray(self._index, dtype="<u8").reshape(-1, 2)
        with open(self._tmp[1], "wb") as f:
            f.write(struct.pack("<QQ", MAGIC, len(index)))
            f.write(index.tobytes())
        for tmp, final in zip(self._tmp, self._paths):
            os.replace(tmp, final)

    def abort(self) -> None:
        """Drop what was written; the store's own files are not touched."""
        self._f.close()
        for tmp in self._tmp:
            if os.path.exists(tmp):
                os.remove(tmp)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()
        else:
            self.abort()


class RecordReader:
    """Random-access reader over the mmapped data file; ``[i]`` unpickles,
    ``get_bytes(i)`` returns the raw bytes."""

    def __init__(self, path: str):
        data, idx = _paths(path)
        if not (os.path.exists(data) and os.path.exists(idx)):
            raise FileNotFoundError(path)
        with open(idx, "rb") as f:
            raw = f.read()
        magic, n = struct.unpack_from("<QQ", raw)
        if magic != MAGIC or len(raw) != 16 + 16 * n:
            raise OSError(f"{idx}: not a record store index")
        self._index = np.frombuffer(raw, dtype="<u8", count=2 * n, offset=16).reshape(n, 2)
        self._f = open(data, "rb")
        try:
            size = os.fstat(self._f.fileno()).st_size
            if size < 8:
                raise OSError(f"{data}: not a record store")
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except BaseException:
            self._f.close()
            raise
        if struct.unpack_from("<Q", self._mm)[0] != MAGIC or (
                n and int((self._index[:, 0] + self._index[:, 1]).max()) > size):
            self.close()
            raise OSError(f"{path}: data file does not match its index")

    def __len__(self) -> int:
        return len(self._index)

    def get_bytes(self, i: int) -> bytes:
        if not 0 <= i < len(self._index):
            raise IndexError(i)
        off, ln = self._index[i]
        return self._mm[int(off):int(off) + int(ln)]

    def __getitem__(self, i: int) -> Any:
        return pickle.loads(self.get_bytes(i))

    def prefetch(self, lo: int, hi: int) -> None:
        """Ask the kernel to read records [lo, hi) ahead (a hint only)."""
        lo, hi = max(int(lo), 0), min(int(hi), len(self._index))
        if hi <= lo or not hasattr(self._mm, "madvise"):
            return
        start = int(self._index[lo, 0]) // mmap.PAGESIZE * mmap.PAGESIZE
        end = int(self._index[hi - 1, 0] + self._index[hi - 1, 1])
        self._mm.madvise(mmap.MADV_WILLNEED, start, end - start)

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        if not self._mm.closed:
            self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
