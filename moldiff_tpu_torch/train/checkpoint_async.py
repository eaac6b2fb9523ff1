"""Checkpoints written off the training loop's thread
(moldiff_tpu/train/checkpoint_sharded.py:267-330, ``AsyncCheckpointer``).

``save`` copies the state to host numpy on the caller's thread (after it
returns, the loop may update the params in place), then pickles and
renames the file atomically on a background thread. One save is in flight
at a time: a new save first waits for the previous one, so the files land
in order. ``wait()`` joins the last save; call it before reading the file
or exiting. An error on the thread is raised by the next ``save`` or
``wait``. The file is the layout of trainer.save_checkpoint (the port's
optimizer under ``extra["optimizer"]``), which the JAX loaders and the
port read.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

from .trainer import TrainState, checkpoint_blob, write_checkpoint


class AsyncCheckpointer:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, state: TrainState, config: Any, scheduler=None,
             extra: Optional[dict] = None) -> None:
        self.wait()
        blob = checkpoint_blob(state, config, scheduler, extra)

        def write():
            try:
                write_checkpoint(path, blob)
            except Exception as e:   # raised by the next save() or wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
