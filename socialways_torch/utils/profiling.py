"""Tracing and step timing.

Counterpart of socialways_tpu/utils/profiling.py: ``trace`` captures a
``torch.profiler`` trace of a block (host activity and, where there is a
card, its kernels and copies) as a Chrome trace that TensorBoard and
Perfetto read; ``StepTimer`` keeps per-step wall times with percentile
summaries.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``<host>_<pid>.<ns>.pt.trace.json`` into
    ``log_dir``.  The device is synchronized before the trace stops, so
    every kernel the block queued is in it."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class StepTimer:
    """Accumulates per-step wall times; reports mean/p50/p99."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self._t0 = 0.0

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p99_s": float(np.percentile(t, 99)),
            "total_s": float(t.sum()),
        }
