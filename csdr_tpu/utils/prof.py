"""Profiling & observability.

The reference's observability is stdout prints of each block's config
(SURVEY.md §5).  Here: per-stage throughput counters, a stream-level
samples/s meter, and a jax.profiler trace context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import jax

__all__ = ["Meter", "StageStat", "stage_table", "trace", "timed_steps"]


@dataclass
class Meter:
    """Streaming throughput meter: feed it (samples, t) increments."""

    name: str = "stream"
    samples: int = 0
    seconds: float = 0.0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def tick(self, n_samples: int):
        now = time.perf_counter()
        if self._t0 is not None:
            self.seconds += now - self._t0
        self._t0 = now
        self.samples += n_samples

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0

    def report(self) -> str:
        return f"{self.name}: {self.samples} samples in {self.seconds:.3f}s = {self.msps:.2f} MSPS"


@dataclass
class StageStat:
    """Per-stage on-device time for Pipeline(profile=True).

    The first call per stage is its jit compile — recorded separately and
    excluded from the steady-state throughput.  ``samples`` counts the
    stage's INPUT samples (each stage's own rate basis), so per-stage MSPS
    are directly comparable to the stream meter at that point in the graph.
    """

    name: str
    seconds: float = 0.0
    samples: int = 0
    calls: int = 0
    compile_seconds: float = 0.0

    def add(self, dt: float, n_in: int):
        self.calls += 1
        if self.calls == 1:
            self.compile_seconds = dt
            return
        self.seconds += dt
        self.samples += n_in

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0


def stage_table(stats: list["StageStat"]) -> str:
    """Budget table over a profiled run — which stage eats the wall clock.
    (The reference only prints static block configs, Liquid.chs `_print`;
    this is the per-block samples/s counter it lacks, SURVEY.md §5.)"""
    total = sum(s.seconds for s in stats) or 1e-12
    w = max([len(s.name) for s in stats] + [5])
    lines = [f"{'stage':<{w}}  {'calls':>5}  {'time_s':>8}  {'MSPS_in':>9}  "
             f"{'pct':>5}  {'compile_s':>9}"]
    for s in stats:
        lines.append(
            f"{s.name:<{w}}  {s.calls - 1 if s.calls else 0:>5}  "
            f"{s.seconds:>8.4f}  {s.msps:>9.2f}  {100 * s.seconds / total:>4.1f}%  "
            f"{s.compile_seconds:>9.3f}")
    lines.append(f"{'TOTAL':<{w}}  {'':>5}  {total:>8.4f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard-compatible) around a code
    region — device timeline, HLO, memory."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_steps(step_fn, state, x, iters: int = 10):
    """Measure a jitted step's steady-state wall time (compile excluded).
    Returns (seconds_per_step, final_state)."""
    state, y = step_fn(state, x)
    jax.block_until_ready(y)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, y = step_fn(state, x)
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / iters, state
