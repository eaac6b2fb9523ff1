"""One process per rank on this host, joined as one run.

:func:`spawn` starts ``fn(rank, world_size, init_method, *args)`` in
``world_size`` fresh interpreters (multiprocessing's spawn: CUDA cannot be
forked), hands them a FileStore rendezvous in a temporary directory (no
TCP port, so concurrent runs never collide) and returns what each rank's
``fn`` returned. A rank that raises fails the run: the others are killed at
once and the parent raises with the rank's traceback, so there is no hang
and no partial success. ``timeout_s`` bounds the whole run when given.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

POLL_S = 0.1


def _run_rank(fn: Callable, rank: int, world_size: int, init_method: str, workdir: str,
              args: tuple) -> None:
    try:
        out = fn(rank, world_size, init_method, *args)
        with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _stop(procs: list) -> None:
    procs = [p for p in procs if p.pid is not None]
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def spawn(fn: Callable, world_size: int, args: tuple = (),
          timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world_size, init_method, *args)`` in one process per
    rank -> the ranks' return values, rank 0 first. ``fn`` and ``args``
    must pickle (a module-level function)."""
    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="moldiff_ranks_")
    init_method = "file://" + os.path.join(workdir, "rendezvous")
    procs = [ctx.Process(target=_run_rank, args=(fn, r, world_size, init_method, workdir, args),
                         name=f"rank{r}") for r in range(world_size)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed:
                break
            if deadline is not None and time.monotonic() > deadline:
                _stop(procs)
                raise TimeoutError(f"{world_size} ranks did not finish in {timeout_s} s")
            time.sleep(POLL_S)
        _stop(procs)
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(workdir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("a rank failed; the run is stopped\n" + "\n".join(errors))
        out = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _stop(procs)
        shutil.rmtree(workdir, ignore_errors=True)
