"""Per-stage device timing + JAX profiler integration.

The reference's profiling is coarse wall-clock (GUI run timer app.rs:205-215,
approximate memory logs runner.rs:132-136, sysinfo footer models.rs:436-463).
The equivalent here is structured: `stage(...)` context managers record
block-until-ready wall times per pipeline stage, and `trace(...)` wraps
jax.profiler for XLA-level traces.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any

import jax


class StageTimer:
    """Accumulates per-stage timings across a run."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *arrays):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for a in arrays:
                jax.block_until_ready(a)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def block(self, name: str, value: Any) -> Any:
        """Time the completion of a device value under `name`."""
        t0 = time.perf_counter()
        jax.block_until_ready(value)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return value

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:<30} {tot * 1000:9.2f} ms  x{n}"
                         f"  ({tot / max(n, 1) * 1000:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """XLA-level profiler trace (view with tensorboard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> dict:
    """Approximate device memory usage (reference logs approximate host
    memory at runner.rs:132-136)."""
    try:
        dev = jax.devices()[0]
        stats = dev.memory_stats()
        return {
            "bytes_in_use": stats.get("bytes_in_use", 0),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
            "bytes_limit": stats.get("bytes_limit", 0),
        }
    except Exception:
        return {}
