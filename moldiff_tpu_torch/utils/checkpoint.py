"""Checkpoint loading for the port (moldiff_tpu/train/trainer.py:424-462).

The JAX package pickles a dict whose ``config`` is a
``moldiff_tpu.utils.config.Config`` and whose params are numpy arrays
(float16 storage in the committed distribution checkpoints). Unpickling
with a plain ``pickle.load`` would import ``moldiff_tpu`` (and with it JAX)
for that one class, and would need numpy 2 for the ``numpy._core`` globals
that numpy 2 writes. The unpickler here maps both, upcasts float16 storage
to float32 as the JAX loader does, and turns the params into torch tensors
in the JAX layout: ``w`` is ``[in, out]`` and the denoiser blocks are
stacked on axis 0, so no leaf is transposed.
"""
from __future__ import annotations

import importlib
import pickle
from typing import Any

import numpy as np
import torch

from .config import Config

_CONFIG_GLOBAL = ("moldiff_tpu.utils.config", "Config")


def _numpy_core_available() -> bool:
    try:
        importlib.import_module("numpy._core")
    except ImportError:
        return False
    return True


def map_global(module: str, name: str, numpy_core: bool) -> tuple:
    """Where a pickled global lives in this process: the JAX package's
    Config becomes the port's copy; ``numpy._core.*`` becomes
    ``numpy.core.*`` when numpy is older than 2."""
    if (module, name) == _CONFIG_GLOBAL:
        return __name__.rsplit(".", 1)[0] + ".config", "Config"
    if module.startswith("moldiff_tpu.") or module == "moldiff_tpu":
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}, which the port does not map")
    if not numpy_core and (module == "numpy._core" or module.startswith("numpy._core.")):
        return "numpy.core" + module[len("numpy._core"):], name
    return module, name


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, numpy_core: bool):
        super().__init__(f)
        self._numpy_core = numpy_core

    def find_class(self, module, name):
        module, name = map_global(module, name, self._numpy_core)
        return super().find_class(module, name)


def _upcast(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_upcast(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype == np.float16:
        return tree.astype(np.float32)
    return tree


def params_to_torch(tree: Any, device: "str | torch.device") -> Any:
    """Nested dict/list of numpy arrays (a ``.ckpt`` tree or the JAX
    package's ``init_params`` output) -> the same nesting of torch tensors
    on ``device``. float16 storage is upcast to float32; other dtypes keep
    their width."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def load_checkpoint_numpy(path: str, numpy_core: "bool | None" = None) -> dict:
    """Unpickle a ``.ckpt`` file; params stay numpy (float16 upcast)."""
    if numpy_core is None:
        numpy_core = _numpy_core_available()
    with open(path, "rb") as f:
        blob = _Unpickler(f, numpy_core).load()
    blob["params"] = _upcast(blob.get("params"))
    if blob.get("ema_params") is not None:
        blob["ema_params"] = _upcast(blob["ema_params"])
    if blob.get("config") is not None and not isinstance(blob["config"], Config):
        blob["config"] = Config(blob["config"])
    return blob


def load_checkpoint(path: str, device: "str | torch.device" = "cuda") -> dict:
    """``.ckpt`` -> dict with ``config`` (Config), ``params`` (torch tensors
    on ``device``) and ``step``. ``ema_params``, when present, are converted
    too; optimizer state is left out (the port does not train yet)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_checkpoint: device cuda requested but CUDA is not available")
    blob = load_checkpoint_numpy(path)
    out = {
        "config": blob.get("config"),
        "params": params_to_torch(blob["params"], device),
        "step": blob.get("step"),
    }
    if blob.get("ema_params") is not None:
        out["ema_params"] = params_to_torch(blob["ema_params"], device)
    return out
