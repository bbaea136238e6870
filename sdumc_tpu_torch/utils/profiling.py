"""Tracing and step timing.

``trace`` wraps ``torch.profiler`` for an on-demand trace of the CPU and,
when a card is present, of CUDA; ``StepTimer`` gives an EMA of the step's
host-clock time and clips/s; ``log_compile_time`` brackets a first call
(a kernel build, a warm-up).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, enabled: bool = True):
    """A ``torch.profiler.profile`` context over the CPU activity, plus
    CUDA's when a card is present; yields the profile (None when not
    `enabled`). On exit ``tensorboard_trace_handler`` writes the trace to
    `logdir` (default ``sdumc_trace`` under the temporary directory) as a
    ``*.pt.trace.json`` file, which Perfetto or chrome://tracing open; no
    tensorboard install is needed to write it."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "sdumc_trace")
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    """Per-step host-clock time with an EMA and clips/s accounting.

    The clock is the host's: a step on the card is measured to its end only
    if the caller synchronises inside the ``with`` (CUDA's launches are
    asynchronous, as JAX's dispatch is)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self.count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        self.count += 1

    def clips_per_sec(self, batch_size: int) -> float:
        return batch_size / self.avg if self.avg else 0.0


@contextlib.contextmanager
def log_compile_time(label: str, log=print):
    """Logs ``[compile] label: Xs`` when the block took over a second."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if dt > 1.0:
        log(f"[compile] {label}: {dt:.1f}s")
