"""Frame statistics + profiler hooks.

Replaces the reference's live telemetry (SURVEY.md §5.1/§5.5): the 1000-entry
frame-time history behind the ImGui/ImPlot Stats window (app.hpp:24,
app.cpp:404-453) becomes a ring buffer with a text summary, and Tracy zones
become jax.profiler traces/annotations viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

FRAME_TIME_HISTORY_SIZE = 1000  # app.hpp:24


class FrameStats:
    def __init__(self, capacity: int = FRAME_TIME_HISTORY_SIZE):
        self.history: deque[float] = deque(maxlen=capacity)
        self._last = None

    def tick(self) -> float:
        """Record a frame boundary; returns the delta time in seconds."""
        now = time.perf_counter()
        dt = 0.0
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                self.history.append(dt)
        self._last = now
        return dt

    def add(self, dt: float) -> None:
        """Record an explicitly-measured frame duration (seconds).

        For callers that bracket ONLY the render + device sync (the CLI's
        --stats): boundary ticks would fold PNG encode / host work between
        frames into the frame time.
        """
        if dt > 0:
            self.history.append(dt)

    @property
    def fps(self) -> float:
        return 1.0 / self.history[-1] if self.history else 0.0

    def summary(self) -> str:
        if not self.history:
            return "no frames"
        times = sorted(self.history)
        n = len(times)
        avg = sum(times) / n
        return (
            f"frames={n} avg={avg*1e3:.2f}ms ({1/avg:.1f} fps) "
            f"p50={times[n//2]*1e3:.2f}ms min={times[0]*1e3:.2f}ms "
            f"max={times[-1]*1e3:.2f}ms"
        )


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/arctic_trace"):
    """jax.profiler trace around a block (open in TensorBoard/Perfetto) —
    the Tracy-capture analogue."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def named_scope(name: str):
    """Pass-through to jax.named_scope — per-pass zone markers
    (TracyD3D12Zone analogue; shows up in XLA HLO names)."""
    import jax

    return jax.named_scope(name)
