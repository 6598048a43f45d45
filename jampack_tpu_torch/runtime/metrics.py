"""Observability: per-stage timing, throughput and ratio accounting (the
port's copy of StageMetrics and InstrumentedEngine of
jampack_tpu/runtime/metrics.py; tests/test_torch_standalone.py holds the
two classes equal to their originals line for line).

The reference has printf-only progress (jampack.cpp:226-231); here every
pipeline stage can be timed per block, aggregated across threads, and
reported as MB/s + share-of-wall-time: the CLI's -v for the stage engines.
"""

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class StageMetrics:
    """Thread-safe accumulator of (stage -> bytes, seconds, calls)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stats = defaultdict(lambda: [0, 0.0, 0])  # bytes, secs, calls

    @contextmanager
    def stage(self, name: str, nbytes: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self.stats[name]
                s[0] += nbytes
                s[1] += dt
                s[2] += 1

    def summary(self) -> dict:
        total = sum(s[1] for s in self.stats.values()) or 1e-12
        out = {}
        for name, (nbytes, secs, calls) in sorted(self.stats.items()):
            out[name] = {
                "MB": round(nbytes / 1e6, 3),
                "s": round(secs, 4),
                "MB/s": round(nbytes / 1e6 / secs, 2) if secs > 0 else None,
                "share": round(secs / total, 3),
                "calls": calls,
            }
        return out

    def report(self) -> str:
        lines = []
        for name, row in self.summary().items():
            lines.append(
                f"  {name:<16} {row['MB']:>10.2f} MB {row['s']:>8.3f} s "
                f"{(row['MB/s'] or 0):>9.1f} MB/s  {row['share']*100:>5.1f}%"
            )
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.summary())


class InstrumentedEngine:
    """Wraps any engine, timing every stage call into a StageMetrics."""

    def __init__(self, engine, metrics: StageMetrics = None):
        self._engine = engine
        self.metrics = metrics or StageMetrics()
        self.name = f"{engine.name}+metrics"

    def __getattr__(self, attr):
        fn = getattr(self._engine, attr)
        if not callable(fn):
            return fn

        def wrapped(data, *args, **kwargs):
            try:
                nbytes = int(getattr(data, "size", 0) or len(data))
            except TypeError:
                nbytes = 0
            with self.metrics.stage(attr, nbytes):
                return fn(data, *args, **kwargs)

        return wrapped
