"""Per-stage timing + device tracing.

JAX equivalent of the reference's REGISTER_TIMES instrumentation
(/root/reference/src/rumi-slam/lib_src/Tracking.h:197-211 per-stage ms
vectors, Tracking::PrintTimeStats Tracking.cc:226) plus jax.profiler hooks
for device-side traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": len(a),
                "mean_ms": float(a.mean() * 1e3),
                "median_ms": float(np.median(a) * 1e3),
                "max_ms": float(a.max() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        rows = ["stage                          n    mean     med     max   total"]
        for name, s in sorted(self.stats().items()):
            rows.append(
                f"{name:28s} {s['n']:4d} {s['mean_ms']:7.2f} "
                f"{s['median_ms']:7.2f} {s['max_ms']:7.2f} {s['total_s']:7.2f}s"
            )
        return "\n".join(rows)


class MemoryMonitor:
    """Background RSS sampler — the reference's memory-usage publisher
    (scripts/nodes/pub_memory.py: psutil RSS at 1 Hz onto
    /cloud_edge_memory_temp, harvested into result.csv via MemoryCb,
    cloud_edge_main.cpp:747).  Samples (t, rss_bytes) into a list."""

    def __init__(self, interval_s: float = 1.0):
        import threading

        self.interval_s = interval_s
        self.samples: list[tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _rss(self) -> int:
        try:
            from ..runtime import native

            return native.rss_bytes()
        except Exception:
            with open("/proc/self/statm") as f:
                import os

                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        t0 = time.perf_counter()
        while not self._stop.wait(self.interval_s):
            self.samples.append((time.perf_counter() - t0, self._rss()))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def peak_mb(self) -> float:
        return max((s[1] for s in self.samples), default=self._rss()) / 1e6

    def mean_mb(self) -> float:
        if not self.samples:
            return self._rss() / 1e6
        return float(np.mean([s[1] for s in self.samples])) / 1e6


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace scope (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
