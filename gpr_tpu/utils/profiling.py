"""Tracing / per-stage timing (SURVEY.md §5.1 rebuild contract).

The reference instruments every pipeline stage with std::chrono and writes
per-frame latency text files (reference apps/GaussianProcessLearn.cpp:
104-162, DataParser.h:211-286).  This module provides the same per-stage
artifacts plus proper device tracing:

  * :class:`StageTimer` — named stages, CSV dump in the reference's
    comma-separated single-line format;
  * :func:`trace` — context manager around ``jax.profiler`` producing a
    TensorBoard-loadable trace directory (XLA op breakdown, device busy time);
  * :func:`device_memory_stats` — live HBM usage per device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class StageTimer:
    """Wall-clock per named stage; ``csv()`` matches the reference's
    trailing-comma latency files (apps/GaussianProcessPredict.cpp:96-105)."""

    def __init__(self) -> None:
        self.stages: List[tuple] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def csv(self) -> str:
        return "".join(f"{dt}," for _, dt in self.stages)

    def write(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(self.csv())


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope: inspect with TensorBoard's profile plugin
    (XLA op timeline, per-op FLOPs, device busy time)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> Dict[str, Dict]:
    """Per-device live/peak HBM bytes where the backend exposes them."""
    import jax

    out: Dict[str, Dict] = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except (AttributeError, NotImplementedError):
            stats = None
        if stats:
            out[str(d)] = {
                "bytes_in_use": stats.get("bytes_in_use"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            }
    return out
