"""Tracing and step timing (moldiff_tpu/utils/profiling.py on torch).

``trace`` records the host and, on a card, the device with
torch.profiler and writes a Chrome trace (chrome://tracing or
ui.perfetto.dev); ``StepTimer`` keeps rolling wall-clock statistics of a
loop; ``device_memory_stats`` reads ``torch.cuda.memory_stats``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(path: str):
    """Profile the body (CPU activity, and CUDA's when a card is there),
    synchronise the card at its end, and write the Chrome trace to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    """Rolling wall-clock statistics of the last ``window`` intervals between
    ``tick`` calls."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps_per_sec": 1.0 / float(np.mean(arr)),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per card, MB in use and the peak since the last reset ({} without a
    card)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for d in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(d)
        if s:
            out[str(d)] = {"bytes_in_use_mb": s.get("allocated_bytes.all.current", 0) / 1e6,
                           "peak_bytes_mb": s.get("allocated_bytes.all.peak", 0) / 1e6}
    return out
