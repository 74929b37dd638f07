"""Structured tracing / step metrics.

The reference's observability is minimal (SURVEY §5: Benchmark wall-clock,
peak memory at exit, per-(bam,chr) elapsed seconds). This rebuild adds the
subsystem SURVEY §5 calls for: named stage timers with hierarchical scopes,
step counters (reads, loci scored, rows scored on the device), the device's
peak memory, and an optional JAX profiler trace capture — all behind a
process-global registry so hot paths pay one perf_counter call per scope.

Usage:
    from pisces_tpu.utils.metrics import metrics
    with metrics.stage("pileup"):
        ...
    metrics.count("reads", n)
    metrics.device_watermark()          # record the device's peak memory
    metrics.report()                    # log a summary table
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

from pisces_tpu.utils.logger import log


class _Stage:
    __slots__ = ("total_s", "calls")

    def __init__(self):
        self.total_s = 0.0
        self.calls = 0


class Metrics:
    """Process-global metric registry; thread-safe, negligible overhead."""

    def __init__(self):
        self._stages: Dict[str, _Stage] = {}
        self._counters: Dict[str, float] = {}
        self._device_peak_bytes = 0
        self._device: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    # -- stage timing ------------------------------------------------------
    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._stages.get(name)
                if s is None:
                    s = self._stages[name] = _Stage()
                s.total_s += dt
                s.calls += 1

    # -- counters ----------------------------------------------------------
    def count(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def rate(self, counter: str, stage: Optional[str] = None) -> float:
        """counter units per second, over a stage's time (or process time)."""
        n = self._counters.get(counter, 0.0)
        if stage is not None and stage in self._stages:
            dt = self._stages[stage].total_s
        else:
            dt = time.perf_counter() - self._t0
        return n / dt if dt > 0 else 0.0

    # -- device memory -----------------------------------------------------
    def device_watermark(self) -> Optional[int]:
        """Record the default device's platform, kind and peak memory in
        use (`peak_bytes_in_use`); returns the peak, or None when the
        backend keeps no memory statistics (the CPU)."""
        import jax
        dev = jax.devices()[0]
        stats = dev.memory_stats()
        with self._lock:
            self._device = {"platform": dev.platform,
                            "device_kind": dev.device_kind,
                            "count": jax.device_count()}
            if not stats:
                return None
            peak = int(stats["peak_bytes_in_use"])
            self._device_peak_bytes = max(self._device_peak_bytes, peak)
            return peak

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "stages": {k: {"seconds": round(v.total_s, 4),
                               "calls": v.calls}
                           for k, v in sorted(self._stages.items())},
                "counters": dict(sorted(self._counters.items())),
                "device": dict(self._device),
                "device_peak_bytes": self._device_peak_bytes,
                "wall_seconds": round(time.perf_counter() - self._t0, 3),
            }

    def report(self, emit=log) -> dict:
        snap = self.snapshot()
        for name, s in snap["stages"].items():
            emit(f"stage {name}: {s['seconds']:.2f}s over {s['calls']} calls")
        for name, n in snap["counters"].items():
            emit(f"counter {name}: {n:,.0f}")
        if snap["device_peak_bytes"]:
            emit(f"device peak memory: "
                 f"{snap['device_peak_bytes'] / (1 << 20):.1f} MiB")
        return snap

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()
            self._counters.clear()
            self._device_peak_bytes = 0
            self._device = {}
            self._t0 = time.perf_counter()


metrics = Metrics()


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """Capture a JAX profiler trace (TensorBoard format) for the enclosed
    region when trace_dir is set; no-op otherwise."""
    if not trace_dir:
        yield
        return
    import jax
    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir):
        yield
