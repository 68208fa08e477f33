"""Profiling hooks: jax.profiler traces + throughput counters.

The reference's only instrumentation is wall-clock prints (SURVEY.md §5);
here long runs can capture real device traces and standardized
steps/sec / samples/sec counters for the BASELINE targets.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace into ``log_dir`` (no-op when None).

    View with TensorBoard or xprof; works on every JAX backend.
    """
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


class Throughput:
    """Rolling samples/sec counter for training loops."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._samples = 0

    def add(self, n: int) -> None:
        self._samples += n

    @property
    def samples_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._samples / dt if dt > 0 else 0.0
