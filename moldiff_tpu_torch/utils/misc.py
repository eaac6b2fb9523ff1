"""Logging, run directories, seeding and the metrics writer (a copy of
moldiff_tpu/utils/misc.py).

The JAX module's ``force_platform_from_env`` (make ``JAX_PLATFORMS`` stick)
has no counterpart: the port's entry points take a ``device`` argument.
Nothing here imports torch.
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Optional

import numpy as np

LOG_FORMAT = "[%(asctime)s::%(name)s::%(levelname)s] %(message)s"


class BlackHole:
    """Absorbs any call and attribute access (reference utils/misc.py:13)."""

    def __setattr__(self, name, value):
        pass

    def __call__(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        return self


def get_logger(name: str, log_dir: Optional[str] = None) -> logging.Logger:
    """A logger to stderr and, when ``log_dir`` is given, to
    ``<log_dir>/log.txt``. Unlike the JAX function, which returns a logger
    that has handlers unchanged, a later call moves the file handler to its
    own ``log_dir``: a process that runs twice (a resumed run, or two
    evaluations) writes each run's log into that run's directory."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter(LOG_FORMAT)
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def get_new_log_dir(root: str = "./logs", prefix: str = "", tag: str = "") -> str:
    """``<root>/[<prefix>_]<local time>[_<tag>]``, created."""
    fn = time.strftime("%Y_%m_%d__%H_%M_%S", time.localtime())
    if prefix:
        fn = prefix + "_" + fn
    if tag:
        fn = fn + "_" + tag
    log_dir = os.path.join(root, fn)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


class MetricsWriter:
    """Append-only JSONL scalar writer with a TensorBoard tee.

    One line per scalar: {"step": int, "tag": str, "value": float, "ts":
    float}. Scalars are also written to a TensorBoard event file
    (utils/tb_writer.py) unless ``tensorboard=False`` or ``MOLDIFF_TB=0``.
    """

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: "bool | None" = None):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, filename), "a", buffering=1)
        if tensorboard is None:
            tensorboard = os.environ.get("MOLDIFF_TB", "1") != "0"
        self._tb = None
        if tensorboard:
            from .tb_writer import TBEventWriter

            self._tb = TBEventWriter(log_dir)

    @property
    def event_path(self) -> Optional[str]:
        """The TensorBoard event file, or None without the tee."""
        return None if self._tb is None else self._tb.path

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps({"step": int(step), "tag": tag, "value": float(value),
                                  "ts": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
