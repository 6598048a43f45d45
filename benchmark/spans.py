"""Host spans around calls into the program's layers.

The benchmark puts them from its own files: a metric's reader names the
functions it needs as SPANS = {span: ["module:attribute", ...]}, and for a
traced run the harness replaces each attribute by a wrapper that records
(span, thread, start, end) on the host clock (time.perf_counter), in
whatever thread calls it: runtime/sharding.py runs a host thread a mesh
entry.  A module attribute is wrapped where the caller looks it up, so a
function imported by name is wrapped in the importing module.  The
harness records the op span, `cli.run`, itself."""

import functools
import importlib
import threading
import time
from contextlib import contextmanager

OP = "cli.run"


class Spans:
    def __init__(self):
        self.records = []  # (name, thread ident, start s, end s)

    def add(self, name: str, start: float, end: float) -> None:
        self.records.append((name, threading.get_ident(), start, end))

    def named(self, name: str) -> list:
        return [(a, b) for n, _, a, b in self.records if n == name]

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, start, time.perf_counter())

        return spanned

    @contextmanager
    def installed(self, targets: dict):
        """Wrap every "module:attr" or "module:Class.attr" of `targets`
        ({span: [target, ...]}) while the block runs.  A target the program
        no longer has raises: a metric must not go quiet unseen."""
        patched = []
        try:
            for name, paths in targets.items():
                for path in paths:
                    module, _, attr = path.partition(":")
                    owner = importlib.import_module(module)
                    *parents, leaf = attr.split(".")
                    for p in parents:
                        owner = getattr(owner, p)
                    fn = getattr(owner, leaf)
                    setattr(owner, leaf, self._wrap(name, fn))
                    patched.append((owner, leaf, fn))
            yield self
        finally:
            for owner, leaf, fn in reversed(patched):
                setattr(owner, leaf, fn)


def union(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the (start, end) intervals cover."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total
