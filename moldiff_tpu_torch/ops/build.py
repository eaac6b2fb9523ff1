"""Build and load the port's CUDA kernels (``moldiff_tpu_torch/csrc``).

The sources have a plain C interface and are compiled by one ``nvcc`` call
into one shared library, loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds. The build goes to
``build/kernels/<hash of the sources>/`` at the root of the checkout, at
first use; a finished build is reused. ``nvcc`` is looked up on ``PATH``,
then in ``$CUDA_HOME/bin``, then in ``/usr/local/cuda/bin``, and runs under
a timeout. Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
LIB_NAME = "libmoldiff_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
COMPILE_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported C functions: name -> argument types (all return a cudaError_t;
# the last argument receives the number of kernels the call launched)
SIGNATURES = {
    "md_node_block_forward": [_P, _I, _I, _I, _I, _I, _P, _P],
    "md_edge_pair_forward": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "md_pos_update_forward": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # ..., need_params, need_time, stream, launched
    "md_node_block_backward": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "md_edge_pair_backward": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "md_pos_update_backward": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "md_edge_block_full_forward": [_P, _I, _I, _I, _I, _I, _I, _P, _P],
    "md_edge_block_full_backward": [_P, _I, _I, _I, _I, _I, _I, _P, _P],
    # the widths as an int array (ops/kernels.py _fused_block_dims)
    "md_fused_block_forward": [_P, _P, _P, _P],
}
# bytes of workspace a backward call needs, from its widths
WORKSPACE_SIGNATURES = {
    # the widths, then need_params
    "md_node_block_backward_workspace": [_I] * 6,
    "md_edge_pair_backward_workspace": [_I] * 8,
    "md_pos_update_backward_workspace": [_I] * 7,
    "md_edge_block_full_backward_workspace": [_I] * 6,
    "md_fused_block_forward_workspace": [_P],
}

_loaded: Optional[ctypes.CDLL] = None
build_log: List[str] = []   # nvcc's output of the build this process made


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def build() -> Path:
    """Compile the kernels unless this version of the sources is built;
    return the library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), *map(str, sources()), "-o", tmp_lib]
        try:
            done = subprocess.run(cmd, timeout=COMPILE_TIMEOUT_S, capture_output=True, text=True)
        except subprocess.TimeoutExpired as exc:
            raise RuntimeError(f"nvcc did not finish within {COMPILE_TIMEOUT_S} s") from exc
        build_log.append(done.stdout + done.stderr)
        if done.returncode != 0:
            raise RuntimeError(f"kernel build failed:\n$ {' '.join(cmd)}\n{build_log[-1]}")
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in WORKSPACE_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        lib.md_error_name.argtypes = [ctypes.c_int]
        lib.md_error_name.restype = ctypes.c_char_p
        _loaded = lib
    return _loaded


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.md_error_name(rc).decode()})")
