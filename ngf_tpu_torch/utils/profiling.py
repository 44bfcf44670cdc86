"""Tracing and step timing: port of `ngf_tpu/utils/profiling.py`.

- ``trace(logdir)``: a ``torch.profiler.profile`` of the host and, where
  there is one, the card, written into ``logdir`` on exit as a Chrome trace
  (``<host>_<pid>.<time>.pt.trace.json``, TensorBoard's profile plugin reads
  it), where the JAX package writes ``jax.profiler``'s.
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``).
- ``StepTimer``: wall-clock step statistics (mean, p50, p95, throughput),
  the JAX package's class as it is.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace is written into ``logdir`` on exit. Yields
    the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof


def annotate(name: str):
    """A named region of the trace, as a context manager."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-step wall times; reports mean/p50/p95 and throughput."""

    def __init__(self, unit_per_step: float = 1.0, unit_name: str = "items"):
        self.times: list[float] = []
        self.unit_per_step = unit_per_step
        self.unit_name = unit_name
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self, last_n: int | None = None) -> dict:
        ts = np.asarray(self.times[-last_n:] if last_n else self.times)
        if ts.size == 0:
            return {}
        return {
            "steps": int(ts.size),
            "mean_ms": float(ts.mean() * 1e3),
            "p50_ms": float(np.percentile(ts, 50) * 1e3),
            "p95_ms": float(np.percentile(ts, 95) * 1e3),
            f"{self.unit_name}_per_sec": float(self.unit_per_step / ts.mean()),
        }

    def __str__(self) -> str:
        s = self.summary()
        if not s:
            return "StepTimer(empty)"
        return (
            f"steps={s['steps']} mean={s['mean_ms']:.2f}ms "
            f"p50={s['p50_ms']:.2f}ms p95={s['p95_ms']:.2f}ms "
            f"{self.unit_name}/s={s[f'{self.unit_name}_per_sec']:,.0f}"
        )
