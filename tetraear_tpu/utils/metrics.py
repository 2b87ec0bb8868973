"""Throughput metrics and profiling hooks.

SURVEY.md §5.1: the reference has no tracing/profiling; these are
greenfield device-native observability — per-block samples/s counters for the
receive loop and a context manager around ``jax.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class ThroughputMeter:
    """Sliding-window samples/s + frames/s counters for the capture loop."""

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._events: list = []          # (t, samples, frames)
        self.total_samples = 0
        self.total_frames = 0
        self._start = clock()

    def record(self, samples: int, frames: int = 0) -> None:
        now = self._clock()
        self._events.append((now, samples, frames))
        self.total_samples += samples
        self.total_frames += frames
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def rates(self) -> Dict[str, float]:
        now = self._clock()
        if not self._events:
            return {"samples_per_sec": 0.0, "frames_per_sec": 0.0,
                    "realtime_factor": 0.0}
        span = max(now - self._events[0][0], 1e-9)
        samples = sum(e[1] for e in self._events)
        frames = sum(e[2] for e in self._events)
        sps = samples / span
        return {"samples_per_sec": sps,
                "frames_per_sec": frames / span,
                "realtime_factor": sps / 2.4e6}

    def summary(self) -> str:
        elapsed = max(self._clock() - self._start, 1e-9)
        r = self.rates()
        return (f"{self.total_samples} samples, {self.total_frames} frames "
                f"in {elapsed:.1f}s | window: {r['samples_per_sec'] / 1e6:.2f} "
                f"MS/s ({r['realtime_factor']:.1f}x realtime), "
                f"{r['frames_per_sec']:.1f} frames/s")


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Wrap a region in a jax.profiler trace (view with TensorBoard/xprof).

    No-op when trace_dir is None or the profiler is unavailable."""
    if not trace_dir:
        yield
        return
    try:
        import jax
        jax.profiler.start_trace(trace_dir)
        started = True
        logger.info("JAX profiler trace -> %s", trace_dir)
    except Exception as e:
        logger.warning("profiler unavailable: %s", e)
        started = False
    try:
        yield
    finally:
        if started:
            try:
                import jax
                jax.profiler.stop_trace()
            except Exception:
                pass
