"""Stage wall-time accounting for the alignment pipeline.

The reference has no profiling at all (SURVEY.md §5 "Tracing/profiling:
none"); this build needs to know where end-to-end time goes —
seed / extend / rescue / cigar host+device phases, per-barcode RFA, and
output IO — so the bench can report a stage breakdown next to the product
pairs/s metric.  Cheap wall timers (one perf_counter pair per stage entry),
thread-safe via a single lock; device stages measure dispatch plus the
wait for the result, i.e. the host's view of the device's time.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class StageTimers:
    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._tls = threading.local()

    @contextmanager
    def suppress(self):
        """Drop stage() accounting on this thread for the duration.

        Used by TpuEngine.warmup: the first call of each executable
        compiles it, and the device batchers' inner fetch timers
        (extend.dispatch.* etc) would otherwise book the compile as
        steady-state stage time.  Warmup keeps its own 'warmup' stage via
        add()."""
        t0 = time.perf_counter()
        self._tls.off = getattr(self._tls, "off", 0) + 1
        try:
            yield
        finally:
            self._tls.off -= 1
            self.add("warmup", time.perf_counter() - t0)

    @contextmanager
    def stage(self, name: str):
        if getattr(self._tls, "off", 0):
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.calls[name] += 1

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.seconds[name] += dt
            self.calls[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"seconds": round(self.seconds[k], 4), "calls": self.calls[k]}
                for k in sorted(self.seconds)
            }

    def summary(self) -> str:
        d = self.as_dict()
        total = sum(v["seconds"] for v in d.values())
        lines = []
        for k, v in sorted(d.items(), key=lambda kv: -kv[1]["seconds"]):
            pct = 100.0 * v["seconds"] / total if total else 0.0
            lines.append(
                f"{k:24s} {v['seconds']:9.3f}s {pct:5.1f}%  x{v['calls']}"
            )
        return "\n".join(lines)


# process-global registry used by the pipeline; bench/profiling resets it
TIMERS = StageTimers()
