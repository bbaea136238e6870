"""The arithmetic the per-layer metrics share, each over a ``RunView``.
A reader that finds nothing to read returns None, and the metric is left
out of the result line."""

from __future__ import annotations

from typing import Optional, Sequence


def span_ms_per_step(view, span: str) -> Optional[float]:
    """Host milliseconds in `span` per step of the window."""
    if not view.window.steps or span not in view.spans.seconds:
        return None
    return 1e3 * view.spans.seconds[span] / view.window.steps


def h2d_ms_per_step(view) -> Optional[float]:
    """Device milliseconds of host-to-device copies per step."""
    if view.trace is None or not view.window.steps or view.trace.h2d_s <= 0:
        return None
    return 1e3 * view.trace.h2d_s / view.window.steps


def mfu_pct(view) -> Optional[float]:
    """The window's frozen products over its seconds over the TF32 peak."""
    if view.peaks is None or view.trace is None or view.window.flops <= 0:
        return None
    return 100.0 * view.window.flops / view.trace.window_s / view.peaks["tf32_flops"]


def roofline_pct(view, kernel: str, names: Sequence[str]) -> Optional[float]:
    """The least time of the kernel's calls in the window (the larger of
    their products over the TF32 peak and their bytes over HBM's rate)
    over the device time of the kernels named `names`."""
    if view.peaks is None or view.trace is None or kernel not in view.window.kernel_work:
        return None
    seconds = view.trace.kernel_seconds(names)
    if seconds <= 0:
        return None
    flops, bytes_ = view.window.kernel_work[kernel]
    bound = max(flops / view.peaks["tf32_flops"], bytes_ / view.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds


def idle_pct(view) -> Optional[float]:
    """Share of the traced window with nothing on the device."""
    if view.trace is None or view.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
