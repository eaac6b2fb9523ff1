"""Sharded checkpoint directories (moldiff_tpu/train/checkpoint_sharded.py:44-265).

Every rank writes only the shards it holds, one ``.npy`` per distinct
shard, keyed by the shard's offsets in the whole leaf; rank 0 writes the
replicated leaves and ``meta.pkl``. Loading assembles any slice of any
leaf from the files, so a directory written at one world size and
placement is read at another (the reshard is a property of the load).

Layout, JAX's::

    <path>/                    (written as <path>.tmp, then renamed)
      meta.pkl                 key paths, leaf specs, config, scheduler, ...
      leaf<i>_o<o0>_<o1>....npy   one per distinct shard ("_or" for a scalar)

The leaves are in the order of JAX's TrainState flatten (params, opt_state,
step, EMA; dict keys sorted), so params leaf i is JAX's leaf i and its
files equal JAX's under the same placement. One departure: a JAX
``PyTreeDef`` cannot be pickled without JAX, so ``meta.pkl`` holds
``paths``, each leaf's key path (dict keys and list indices), in place of
``treedef``. A directory JAX wrote is read all the same: its treedef is
decoded from the pickle's node records without jaxlib (:func:`read_meta`),
and its params, EMA and step are returned (its optax state is not: the
port starts a fresh optimizer from it, as from a distribution checkpoint).
"""
from __future__ import annotations

import os
import pickle
import shutil
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.checkpoint import map_global, _numpy_core_available

META_NAME = "meta.pkl"


def is_sharded_checkpoint(path: str) -> bool:
    """True iff ``path`` is a sharded checkpoint directory."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, META_NAME))


def key_paths(tree: Any, prefix: tuple = ()) -> list:
    """(key path, leaf) of a nested dict / list tree, dict keys sorted (the
    order of utils/tree.py tree_leaves and of jax.tree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in key_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in key_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def build_tree(paths: List[tuple], leaves: List[Any]) -> dict:
    """The nested dict / list tree whose key paths are ``paths`` (int keys
    make lists)."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _shard_filename(leaf_i: int, index) -> str:
    """A shard's file, named by its offsets in the whole leaf (slice
    starts; "r" for a scalar)."""
    offs = [0 if s.start is None else int(s.start) for s in index]
    tag = "_".join(str(o) for o in offs) if offs else "r"
    return f"leaf{leaf_i}_o{tag}.npy"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save_checkpoint_sharded(path: str, entries: list, rank: int = 0, world: int = 1,
                            config=None, scheduler=None, key=None, extra=None,
                            coords: Optional[dict] = None) -> None:
    """Write a sharded checkpoint directory from ``entries``: (key path,
    this rank's array, parallel.mesh.Placement) per leaf. ``coords``: this
    rank's coordinate on each mesh axis (default ``{"data": rank}``). A
    sharded leaf's slice is written by the rank that holds it at
    coordinate 0 of every other axis, a replicated leaf by rank 0 (JAX's
    replica 0). Every rank of the process group calls it: rank 0 makes
    ``<path>.tmp``, all write, rank 0 writes meta.pkl and renames it into
    place, with a barrier between the steps (JAX's sync_global_devices)."""
    coords = coords if coords is not None else {"data": rank}
    tmp = path + ".tmp"
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _barrier()
    specs = []
    for i, (_, x, place) in enumerate(entries):
        arr = _host(x)
        specs.append({"shape": tuple(place.shape), "dtype": str(arr.dtype),
                      "sharded": place.dim is not None})
        if place.dim is None:
            writes = rank == 0
        else:
            writes = all(c == 0 for a, c in coords.items() if a != place.axis)
        if writes:
            index = place.index(coords.get(place.axis, 0) if place.dim is not None else 0)
            np.save(os.path.join(tmp, _shard_filename(i, index)), np.asarray(arr, order="C"))
    if rank == 0:
        meta = {"paths": [p for p, _, _ in entries], "specs": specs,
                "config": config.to_dict() if hasattr(config, "to_dict") else config,
                "scheduler": scheduler.state_dict() if scheduler is not None else None,
                "key": key, "extra": extra, "world": world}
        with open(os.path.join(tmp, META_NAME), "wb") as f:
            pickle.dump(meta, f, protocol=pickle.HIGHEST_PROTOCOL)
    _barrier()
    if rank == 0:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    _barrier()


class _LeafReader:
    """Reads one leaf's shards; aligned slices hit single files, anything
    else assembles the whole leaf once and serves slices from it
    (checkpoint_sharded.py:146-209)."""

    def __init__(self, dirpath: str, leaf_i: int, spec: dict):
        self.dir = dirpath
        self.i = leaf_i
        self.spec = spec
        self._full: Optional[np.ndarray] = None
        self._lock = threading.Lock()

    def full(self) -> np.ndarray:
        with self._lock:
            if self._full is None:
                shape = tuple(self.spec["shape"])
                prefix = f"leaf{self.i}_o"
                files = [f for f in os.listdir(self.dir)
                         if f.startswith(prefix) and f.endswith(".npy")]
                if len(files) == 1:
                    arr = np.load(os.path.join(self.dir, files[0]))
                    if tuple(arr.shape) != shape:
                        raise ValueError(
                            f"leaf {self.i}: single shard {arr.shape} does not cover {shape} "
                            "- checkpoint written on a filesystem not shared by all processes?")
                    self._full = arr
                else:
                    out = np.empty(shape, np.dtype(self.spec["dtype"]))
                    covered = np.zeros(shape, bool)
                    for f in files:
                        part = np.load(os.path.join(self.dir, f))
                        offs = [int(o) for o in f[len(prefix):-len(".npy")].split("_")]
                        sl = tuple(slice(o, o + s) for o, s in zip(offs, part.shape))
                        out[sl] = part
                        covered[sl] = True
                    if not covered.all():
                        raise ValueError(
                            f"leaf {self.i}: shards cover only {covered.mean():.0%} of {shape} "
                            "- missing files (non-shared filesystem?)")
                    self._full = out
            return self._full

    def read(self, index) -> np.ndarray:
        fname = os.path.join(self.dir, _shard_filename(self.i, index))
        if os.path.exists(fname):
            part = np.load(fname)
            want = tuple((0 if s.start is None else s.start,
                          self.spec["shape"][d] if s.stop is None else s.stop)
                         for d, s in enumerate(index))
            if all(hi - lo == ps for (lo, hi), ps in zip(want, part.shape)):
                return part
        return self.full()[index]


# -- meta.pkl, the port's or JAX's ------------------------------------------------

class _Stub:
    """Stands in for a JAX or optax class while meta.pkl is unpickled."""
    module = name = ""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


def _stub(module: str, name: str) -> type:
    return type(name, (_Stub,), {"module": module, "name": name})


class _MetaUnpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._numpy_core = _numpy_core_available()

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("jax", "jaxlib", "optax") or (module, name) == (
                "moldiff_tpu.train.trainer", "TrainState"):
            return _stub(module, name)
        return super().find_class(*map_global(module, name, self._numpy_core))


def _treedef_skeleton(treedef: _Stub) -> Any:
    """A JAX PyTreeDef's structure rebuilt from its pickled node records
    (kind, arity, node data, ..., leaves, nodes), post-order: leaves become
    their indices, dicts and lists stay, tuples and namedtuples become
    tuples. Raises ValueError for a record it does not know."""
    nodes = treedef.state[1]
    stack: list = []
    leaf = 0
    for kind, arity, data, *_ in nodes:
        if kind == 0:                     # leaf
            stack.append(leaf)
            leaf += 1
            continue
        if kind == 1:                     # None
            stack.append(None)
            continue
        children = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        if kind == 5:                     # dict, keys sorted
            stack.append(dict(zip(data, children)))
        elif kind == 4:                   # list
            stack.append(list(children))
        elif kind in (2, 3):              # tuple, namedtuple
            stack.append(tuple(children))
        else:
            raise ValueError(f"a pytree node of kind {kind} (custom) cannot be read "
                             "without JAX")
    if len(stack) != 1:
        raise ValueError("malformed treedef")
    return stack[0]


def _leaf_paths(skeleton: Any, prefix: tuple = ()) -> list:
    """(key path, leaf index) of a skeleton's leaves."""
    if isinstance(skeleton, dict):
        return [x for k in sorted(skeleton) for x in _leaf_paths(skeleton[k], prefix + (k,))]
    if isinstance(skeleton, (list, tuple)):
        return [x for i, v in enumerate(skeleton) for x in _leaf_paths(v, prefix + (i,))]
    if skeleton is None:
        return []
    return [(prefix, skeleton)]


def read_meta(path: str) -> dict:
    """meta.pkl of a sharded checkpoint, with ``paths`` (one key path per
    leaf; None for a leaf this reader does not return). For a directory
    the JAX package wrote, the treedef of its TrainState(params, opt_state,
    step, ema_params) is decoded without jaxlib: params, step and EMA get
    their paths, the optax state's leaves None. A treedef that cannot be
    decoded raises ValueError, naming why."""
    with open(os.path.join(path, META_NAME), "rb") as f:
        try:
            meta = _MetaUnpickler(f).load()
        except Exception as e:
            raise ValueError(f"{path}: meta.pkl cannot be read without JAX ({e})") from e
    if "paths" in meta:
        return meta
    treedef = meta.get("treedef")
    if not isinstance(treedef, _Stub) or not isinstance(getattr(treedef, "state", None), tuple):
        raise ValueError(f"{path}: meta.pkl holds neither key paths nor a treedef the port "
                         "can decode")
    skeleton = _treedef_skeleton(treedef)
    if not (isinstance(skeleton, tuple) and len(skeleton) == 4):
        raise ValueError(f"{path}: not a TrainState(params, opt_state, step, ema_params) "
                         "checkpoint")
    paths: List[Optional[tuple]] = [None] * len(meta["specs"])
    for field, name in ((0, "params"), (2, "step"), (3, "ema_params")):
        for p, i in _leaf_paths(skeleton[field]):
            paths[i] = (name,) + p
    return dict(meta, paths=paths)


def load_checkpoint_sharded(path: str,
                            select: Optional[Callable[[tuple, tuple], Optional[tuple]]] = None
                            ) -> dict:
    """Read a sharded checkpoint directory -> {"state", "config",
    "scheduler", "key", "extra", "paths"}. ``state`` is the nested dict of
    the key paths (``params``, ``opt_state``, ``step``, ``ema_params``) of
    numpy arrays. ``select(key path, whole shape)``: the index (a tuple of
    slices) of the part of a leaf to read, e.g. this rank's shard under
    another placement, or None for the whole leaf."""
    meta = read_meta(path)
    paths, leaves = [], []
    for i, (p, spec) in enumerate(zip(meta["paths"], meta["specs"])):
        if p is None:
            continue
        reader = _LeafReader(path, i, spec)
        index = select(p, tuple(spec["shape"])) if select is not None else None
        arr = reader.full() if index is None else reader.read(index)
        paths.append(p)
        leaves.append(np.asarray(arr).astype(np.dtype(spec["dtype"])))
    state = build_tree(paths, leaves)
    state.setdefault("opt_state", None)
    state.setdefault("ema_params", None)
    return {"state": state, "config": meta.get("config"), "scheduler": meta.get("scheduler"),
            "key": meta.get("key"), "extra": meta.get("extra"), "paths": paths}
